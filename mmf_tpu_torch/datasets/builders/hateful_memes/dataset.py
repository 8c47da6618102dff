"""The Hateful Memes datasets.

Port of ``mmf_tpu/datasets/builders/hateful_memes/dataset.py``: each
sample is a meme's text through the text processor, its ``id``, and
either the image (``HatefulMemesImageDataset``: ``img`` from the image
database through the ``image_processor``, as ``image`` [3, H, W]
float32) or its region features (``HatefulMemesFeaturesDataset``:
``<image stem>.npy`` from the features database); ``targets`` is the
label, or, with ``fg_dataset_type``, the fine-grained labels' multi-hot
scores. Predictions are ``{"id", "proba", "label"}`` rows
(``generate_binary_prediction``; ``csv`` with
``evaluation.predict_file_format``), or ``{"id", "scores"}`` for a
multilabel dataset. Features in ``.lmdb`` files raise in the features
reader, which waits for the LMDB port.
"""

from __future__ import annotations

import numpy as np

from mmf_tpu_torch.common.sample import Sample
from mmf_tpu_torch.datasets.mmf_dataset import MMFDataset


def generate_binary_prediction(report):
    """The softmax probability of class 1 and the argmax label of each
    row of ``report["scores"]``."""
    scores = np.asarray(report["scores"])
    ex = np.exp(scores - scores.max(-1, keepdims=True))
    probs = ex / ex.sum(-1, keepdims=True)
    labels = scores.argmax(axis=1)
    return [{"id": int(np.asarray(id_)), "proba": float(probs[idx, 1]),
             "label": int(labels[idx])}
            for idx, id_ in enumerate(report["id"])]


def generate_multilabel_prediction(report):
    """The sigmoid of every score of each row."""
    scores = 1.0 / (1.0 + np.exp(-np.asarray(report["scores"])))
    return [{"id": int(np.asarray(id_)), "scores": scores[idx].tolist()}
            for idx, id_ in enumerate(report["id"])]


def _text_sample(dataset, sample_info) -> Sample:
    sample = Sample()
    processed = dataset.text_processor({"text": sample_info["text"]})
    sample.text = processed["text"]
    if "input_ids" in processed:
        sample.update(processed)
    sample.id = np.int32(int(sample_info["id"]))
    return sample


class _HatefulMemesDataset(MMFDataset):
    def __init__(self, config, *args, dataset_name="hateful_memes",
                 **kwargs):
        super().__init__(dataset_name, config, *args, **kwargs)
        self.is_multilabel = self.config.get("is_multilabel", False)

    def format_for_prediction(self, report):
        if self.is_multilabel:
            return generate_multilabel_prediction(report)
        return generate_binary_prediction(report)


class HatefulMemesFeaturesDataset(_HatefulMemesDataset):
    def __init__(self, config, *args, dataset_name="hateful_memes",
                 **kwargs):
        super().__init__(config, *args, dataset_name=dataset_name, **kwargs)
        if not self._use_features:
            raise ValueError(
                "config's 'use_features' must be true to use features "
                "dataset")

    def preprocess_sample_info(self, sample_info):
        stem = sample_info["img"].split("/")[-1].split(".")[0]
        sample_info["feature_path"] = f"{stem}.npy"
        return sample_info

    def __getitem__(self, idx):
        sample_info = self.preprocess_sample_info(self.annotation_db[idx])
        sample = _text_sample(self, sample_info)
        sample.update(self._process_feature_info(
            self.features_db.get(sample_info)))
        fg_dataset_type = self.config.get("fg_dataset_type", None)
        if fg_dataset_type:
            sample = self.process_fg_labels(fg_dataset_type, sample_info,
                                            sample)
        elif "label" in sample_info:
            sample.targets = np.int64(sample_info["label"])
        return sample

    def process_fg_labels(self, fg_dataset_type, sample_info, sample):
        """The fine-grained labels of ``fg_dataset_type`` (``attack``,
        ``pc``, ``pc_attack``, ``hateful_pc_attack``) through the answer
        processor: ``answers`` and their scores as ``targets``."""
        attacks = sample_info["top_attacks"]
        groups = sample_info["top_protectedcats"]
        hateful = ["hateful" if int(sample_info["label"]) == 1
                   else "not_hateful"]
        labels = {"attack": attacks, "pc": groups,
                  "pc_attack": groups + attacks,
                  "hateful_pc_attack": groups + attacks + hateful}
        processed = self.answer_processor(
            {"answers": labels[fg_dataset_type]})
        sample.answers = processed["answers"]
        sample.targets = processed["answers_scores"]
        return sample


class HatefulMemesImageDataset(_HatefulMemesDataset):
    def __init__(self, config, *args, dataset_name="hateful_memes",
                 **kwargs):
        super().__init__(config, *args, dataset_name=dataset_name, **kwargs)
        if not self._use_images:
            raise ValueError(
                "config's 'use_images' must be true to use image dataset")

    def init_processors(self):
        super().init_processors()
        if hasattr(self, "image_processor"):
            self.image_db.transform = self.image_processor

    def __getitem__(self, idx):
        sample_info = self.annotation_db[idx]
        sample = _text_sample(self, sample_info)
        sample.image = self.image_db[idx]["images"][0]
        if "label" in sample_info:
            sample.targets = np.int64(sample_info["label"])
        return sample
