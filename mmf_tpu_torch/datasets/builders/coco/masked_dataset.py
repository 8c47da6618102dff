"""The masked COCO pretraining dataset.

Port of ``mmf_tpu/datasets/builders/coco/masked_dataset.py``: a row an
image. One of its captions, drawn with Python's ``random``, goes through
the masked-token processor, paired (``two_sentence``) with another of
its captions or, at ``1 - two_sentence_probability``, a caption of
another image, or (``false_caption``) swapped for another image's
caption at ``false_caption_probability``; ``is_correct`` says which
(-1 when neither is set). The region features come with their
masked-region labels (``add_masked_features``). The draws are JAX's, in
JAX's order.
"""

from __future__ import annotations

import random

from mmf_tpu_torch.common.sample import Sample
from mmf_tpu_torch.datasets.builders.coco.dataset import COCODataset


class MaskedCOCODataset(COCODataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        kwargs.setdefault("dataset_name", "masked_coco")
        super().__init__(config, dataset_type, imdb_file_index, *args,
                         **kwargs)
        self.dataset_name = kwargs["dataset_name"]
        self._two_sentence = config.get("two_sentence", True)
        self._false_caption = config.get("false_caption", True)
        self._two_sentence_probability = config.get(
            "two_sentence_probability", 0.5)
        self._false_caption_probability = config.get(
            "false_caption_probability", 0.5)

    def load_item(self, idx):
        sample_info = self.annotation_db[idx]
        current_sample = Sample()
        if self._use_features:
            current_sample = self.add_masked_features(idx, current_sample)
        else:
            image_path = str(sample_info["image_name"]) + ".jpg"
            current_sample.image = self.image_db.from_path(image_path)[
                "images"][0]
        return self._add_masked_caption(sample_info, current_sample)

    def _add_masked_caption(self, sample_info, current_sample):
        captions = sample_info["captions"]
        image_id = sample_info["image_id"]
        selected_index = random.randrange(len(captions))
        selected_caption = captions[selected_index]
        other_caption = None
        is_correct = -1

        if self._two_sentence:
            if random.random() > self._two_sentence_probability:
                other_caption = self._get_mismatching_caption(image_id)
                is_correct = False
            else:
                others = [i for i in range(len(captions))
                          if i != selected_index]
                # a single-caption image pairs its caption with itself
                other_caption = captions[
                    random.choice(others) if others else selected_index]
                is_correct = True
        elif self._false_caption:
            if random.random() < self._false_caption_probability:
                selected_caption = self._get_mismatching_caption(image_id)
                is_correct = False
            else:
                is_correct = True

        processed = self.masked_token_processor({
            "text_a": selected_caption,
            "text_b": other_caption,
            "is_correct": is_correct,
        })
        processed.pop("tokens", None)
        current_sample.update(processed)
        return current_sample

    def _get_mismatching_caption(self, image_id):
        other = self.annotation_db[random.randrange(len(self.annotation_db))]
        while other["image_id"] == image_id:
            other = self.annotation_db[
                random.randrange(len(self.annotation_db))]
        return other["captions"][random.randrange(len(other["captions"]))]
