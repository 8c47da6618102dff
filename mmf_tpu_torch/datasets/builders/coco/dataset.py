"""The COCO captioning dataset.

Port of ``mmf_tpu/datasets/builders/coco/dataset.py``: a row a caption.
The caption's tokens go through the text processor (``text``, with
``caption_id`` and ``caption_len``) except in the test split; the
image's region features come from the features database, or the image
itself from the image database; ``answers`` holds the image's first
``min_captions_per_img`` reference captions, each through the text
processor; ``image_id`` is packed as a byte tensor. Predictions decode
the report's ``captions`` through the caption processor into
``{"image_id", "caption"}`` rows.
"""

from __future__ import annotations

import numpy as np

from mmf_tpu_torch.common.sample import Sample
from mmf_tpu_torch.datasets.builders.vqa2.dataset import VQA2Dataset
from mmf_tpu_torch.utils.distributed import (
    byte_tensor_to_object,
    object_to_byte_tensor,
)


class COCODataset(VQA2Dataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        kwargs.setdefault("dataset_name", "coco")
        super().__init__(config, dataset_type, imdb_file_index, *args,
                         **kwargs)

    def preprocess_sample_info(self, sample_info):
        if "COCO" not in sample_info["feature_path"]:
            sample_info["feature_path"] = sample_info["image_path"].replace(
                ".jpg", ".npy")
        return sample_info

    def load_item(self, idx):
        sample_info = self.preprocess_sample_info(self.annotation_db[idx])
        current_sample = Sample()

        if self._dataset_type != "test":
            processed = self.text_processor(
                {"tokens": sample_info["caption_tokens"]})
            current_sample.text = processed["text"]
            current_sample.caption_id = np.int32(sample_info["caption_id"])
            current_sample.caption_len = np.int32(
                len(sample_info["caption_tokens"]))

        current_sample.image_id = object_to_byte_tensor(
            sample_info["image_id"])
        if self._use_features:
            current_sample.update(self.features_db[idx])
        else:
            image_path = str(sample_info["image_name"]) + ".jpg"
            current_sample.image = self.image_db.from_path(image_path)[
                "images"][0]
        return self.add_reference_caption(sample_info, current_sample)

    def add_reference_caption(self, sample_info, sample):
        references = [self.text_processor({"tokens": tokens})["text"]
                      for tokens in sample_info["reference_tokens"]]
        sample.answers = np.stack(references)[
            : self.config["min_captions_per_img"]]
        return sample

    def format_for_prediction(self, report):
        captions = np.asarray(report["captions"]).tolist()
        remove_unk = self.config.get("remove_unk_from_caption_prediction",
                                     False)
        predictions = []
        for idx, image_id in enumerate(report["image_id"]):
            if isinstance(image_id, np.ndarray):
                image_id = byte_tensor_to_object(image_id)
            caption = self.caption_processor(captions[idx])["caption"]
            if remove_unk:
                caption = caption.replace("<unk>", "")
                caption = caption.replace("  ", " ").strip()
            predictions.append({"image_id": image_id, "caption": caption})
        return predictions
