"""The VQA2 dataset.

Port of ``mmf_tpu/datasets/builders/vqa2/dataset.py``: a question through
the text processor, the image's region features from the features
database (``use_features``) or the image itself (``use_images``:
``<image_name>.jpg`` from the image database, through the
``image_processor``, as ``image`` [3, H, W] float32), the soft answer
scores as ``targets``, and the predictions formatted as
``{"question_id", "answer"}`` rows. The OCR fields wait for the
``vqa2_ocr`` builder.
"""

from __future__ import annotations

import logging

import numpy as np

from mmf_tpu_torch.common.sample import Sample
from mmf_tpu_torch.datasets.mmf_dataset import MMFDataset

logger = logging.getLogger(__name__)


class VQA2Dataset(MMFDataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        name = kwargs.get("name", kwargs.get("dataset_name", "vqa2"))
        super().__init__(name, config, dataset_type, index=imdb_file_index)
        self._should_fast_read = self.config.get("fast_read", False)
        if self.config.get("use_ocr", False) or self.config.get(
                "use_ocr_info", False):
            raise NotImplementedError(
                "use_ocr / use_ocr_info: the OCR fields come with the "
                "vqa2_ocr builder, which is not ported yet")

    def init_processors(self):
        super().init_processors()
        if not self._use_features and hasattr(self, "image_processor"):
            self.image_db.transform = self.image_processor

    def try_fast_read(self):
        if self._dataset_type == "test":
            return
        if getattr(self, "_should_fast_read", False):
            logger.info(
                f"Starting to fast read {self.dataset_name} "
                f"{self.dataset_type} dataset"
            )
            self.cache = {}
            for idx in range(len(self.annotation_db)):
                self.cache[idx] = self.load_item(idx)

    def __getitem__(self, idx):
        # builders that never call try_fast_read (COCO-family subclasses
        # go through MMFDatasetBuilder.load) have no cache — fall through
        # to a normal load instead of AttributeError on the first batch
        if self._should_fast_read and self._dataset_type != "test" \
                and hasattr(self, "cache"):
            return self.cache[idx]
        return self.load_item(idx)

    def load_item(self, idx):
        sample_info = self.annotation_db[idx]
        current_sample = Sample()

        if "question_tokens" in sample_info:
            text_processor_argument = {
                "tokens": sample_info["question_tokens"],
                "text": sample_info["question_str"],
            }
        else:
            text_processor_argument = {"text": sample_info["question"]}
        processed_question = self.text_processor(text_processor_argument)
        current_sample.text = processed_question["text"]
        if "input_ids" in processed_question:
            current_sample.update(processed_question)

        current_sample.question_id = np.int32(sample_info["question_id"])
        if isinstance(sample_info["image_id"], int):
            current_sample.image_id = np.int32(sample_info["image_id"])
        else:
            current_sample.image_id = sample_info["image_id"]

        if "question_tokens" in sample_info:
            current_sample.text_len = np.int32(
                len(sample_info["question_tokens"])
            )

        if self._use_features:
            features = self._process_feature_info(
                self.features_db[idx]
            )
            current_sample.update(features)
        else:
            # the file is named .jpg; the loader goes by its content
            image_path = sample_info["image_name"] + ".jpg"
            current_sample.image = self.image_db.from_path(image_path)[
                "images"][0]

        return self.add_answer_info(sample_info, current_sample)

    def add_answer_info(self, sample_info, sample):
        if "answers" in sample_info:
            answers = sample_info["answers"]
            processed = self.answer_processor({"answers": answers})
            sample.targets = processed["answers_scores"]
        return sample

    def format_for_prediction(self, report):
        """One ``{"question_id", "answer"}`` row a question: the answer
        of the largest score (the OCR copy slots of ``vqa2_ocr`` wait for
        that builder)."""
        answers = np.asarray(report["scores"]).argmax(axis=1)
        predictions = []
        for idx, question_id in enumerate(report["question_id"]):
            answer = self.answer_processor.idx2word(int(answers[idx]))
            predictions.append(
                {"question_id": int(np.asarray(question_id)),
                 "answer": answer}
            )
        return predictions
