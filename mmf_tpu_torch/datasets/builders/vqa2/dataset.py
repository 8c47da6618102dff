"""The VQA2 dataset.

Port of ``mmf_tpu/datasets/builders/vqa2/dataset.py``: a question through
the text processor, the image's region features from the features
database (``use_features``) or the image itself (``use_images``:
``<image_name>.jpg`` from the image database, through the
``image_processor``, as ``image`` [3, H, W] float32), the soft answer
scores as ``targets``, and the predictions formatted as
``{"question_id", "answer"}`` rows. With ``use_ocr`` (LoRRA's
configs, the ``vqa2_ocr`` builder, VizWiz) a sample also holds its OCR
tokens through the ``context_processor`` (``context``, the padded
``context_tokens`` as strings, ``context_feature_0``, its length as
``context_info_0.max_features``) and the ``order_vectors`` (an identity
zeroed past the length), and the answer processor scores the OCR copy
slots (``soft_copy_answer``); with ``use_ocr_info`` the OCR boxes
(``ocr_bbox``). A prediction past the answer space copies its OCR token
(the pad token answers "unanswerable").
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
        self.use_ocr = self.config.get("use_ocr", False)
        self.use_ocr_info = self.config.get("use_ocr_info", False)

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

        return self.add_answer_info(sample_info,
                                    self.add_ocr_details(sample_info,
                                                         current_sample))

    def add_ocr_details(self, sample_info, sample):
        if self.use_ocr:
            ocr_tokens = [
                self.ocr_token_processor({"text": token})["text"]
                for token in sample_info["ocr_tokens"]
            ]
            context = self.context_processor({"tokens": ocr_tokens})
            sample.context = context["text"]
            sample.context_tokens = context["tokens"]
            sample.context_feature_0 = context["text"]
            sample.context_info_0 = Sample()
            sample.context_info_0.max_features = context["length"]

            order_vectors = np.eye(len(sample.context_tokens),
                                   dtype=np.float32)
            order_vectors[int(context["length"]):] = 0
            sample.order_vectors = order_vectors

        if self.use_ocr_info and "ocr_info" in sample_info:
            sample.ocr_bbox = self.bbox_processor(
                {"info": sample_info["ocr_info"]})["bbox"]
        return sample

    def add_answer_info(self, sample_info, sample):
        if "answers" in sample_info:
            answer_processor_arg = {"answers": sample_info["answers"]}
            if self.use_ocr:
                answer_processor_arg["tokens"] = sample_info["ocr_tokens"]
            processed = self.answer_processor(answer_processor_arg)
            sample.targets = processed["answers_scores"]
        return sample

    def format_for_prediction(self, report):
        """One ``{"question_id", "answer"}`` row a question: the answer
        of the largest score; an index past the answer space copies that
        slot of the question's ``context_tokens``, and the pad token
        answers "unanswerable"."""
        answers = np.asarray(report["scores"]).argmax(axis=1)
        predictions = []
        answer_space_size = self.answer_processor.get_true_vocab_size()
        for idx, question_id in enumerate(report["question_id"]):
            answer_id = int(answers[idx])
            if answer_id >= answer_space_size:
                answer_id -= answer_space_size
                answer = report["context_tokens"][idx][answer_id]
                if answer == self.context_processor.PAD_TOKEN:
                    answer = "unanswerable"
            else:
                answer = self.answer_processor.idx2word(answer_id)
            predictions.append(
                {"question_id": int(np.asarray(question_id)),
                 "answer": answer}
            )
        return predictions
