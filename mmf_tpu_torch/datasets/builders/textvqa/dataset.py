"""The TextVQA dataset (M4C's).

Port of ``mmf_tpu/datasets/builders/textvqa/dataset.py``. A sample holds
the question through the text processor (``text``, ``text_len``), the
object features (``image_feature_0``, the first LMDB) and the OCR boxes'
features (``image_feature_1``, the second) with only ``max_features``
kept of their infos, the objects' boxes (``obj_bbox_coordinates``), the
OCR tokens as fasttext vectors (``context_feature_0``, also ``context``)
and PHOC vectors (``context_feature_1``) with their counts, the
``order_vectors``, the OCR boxes (``ocr_bbox_coordinates``), M4C's
decoding targets from the ``m4c_answer`` processor (``targets``,
``train_prev_inds``, ``train_loss_mask``, ``sampled_idx_seq``) and, packed
with ``object_to_byte_tensor`` so that they batch, ``image_id``,
``context_tokens`` and ``answers``. ``format_for_prediction`` turns the
greedy-decoded ids back into answer strings.
"""

from __future__ import annotations

import numpy as np

from mmf_tpu_torch.common.sample import Sample
from mmf_tpu_torch.datasets.mmf_dataset import MMFDataset
from mmf_tpu_torch.utils.distributed import (
    byte_tensor_to_object,
    object_to_byte_tensor,
)
from mmf_tpu_torch.utils.text import word_tokenize


class TextVQADataset(MMFDataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        super().__init__(
            kwargs.get("dataset_name", "textvqa"), config, dataset_type,
            index=imdb_file_index,
        )
        self.use_ocr = self.config.get("use_ocr", True)
        self.use_ocr_info = self.config.get("use_ocr_info", False)

    def preprocess_sample_info(self, sample_info):
        path = self._get_path_based_on_index(
            self.config, "annotations", self._index
        )
        if "stvqa" in path:
            feature_path = sample_info["feature_path"]
            append = "train" if self.dataset_type != "test" else "test_task3"
            if not feature_path.startswith(append):
                feature_path = append + "/" + feature_path
            sample_info["feature_path"] = feature_path
            return sample_info
        elif "COCO" not in sample_info["feature_path"]:
            sample_info["feature_path"] = sample_info["image_path"].replace(
                ".jpg", ".npy"
            )
        return sample_info

    def postprocess_evalai_entry(self, entry):
        return entry

    def format_for_prediction(self, report):
        """One ``{"question_id", "image_id", "answer", "pred_source"}``
        row a question: the decoded ids up to the first ``</s>``, each
        a vocabulary word or a copied OCR token."""
        answer_processor = self.answer_processor
        scores = np.asarray(report["scores"])
        batch_size = len(report["question_id"])
        pred_answers = scores.argmax(axis=-1).reshape(batch_size, -1)
        answer_space_size = answer_processor.get_true_vocab_size()

        predictions = []
        for idx, question_id in enumerate(report["question_id"]):
            image_id = report["image_id"][idx]
            if isinstance(image_id, np.ndarray):
                image_id = byte_tensor_to_object(image_id)
            tokens = report["context_tokens"][idx]
            if isinstance(tokens, np.ndarray):
                tokens = byte_tensor_to_object(tokens)
            answer_words = []
            pred_source = []
            for answer_id in pred_answers[idx].tolist():
                answer_id = int(answer_id)
                if answer_id >= answer_space_size:
                    answer_id -= answer_space_size
                    answer_words.append(word_tokenize(tokens[answer_id]))
                    pred_source.append("OCR")
                else:
                    if answer_id == answer_processor.EOS_IDX:
                        break
                    answer_words.append(
                        answer_processor.answer_vocab.idx2word(answer_id)
                    )
                    pred_source.append("VOCAB")
            pred_answer = " ".join(answer_words).replace(" 's", "'s")
            entry = {
                "question_id": int(np.asarray(question_id)),
                "image_id": image_id,
                "answer": pred_answer,
                "pred_source": pred_source,
            }
            predictions.append(self.postprocess_evalai_entry(entry))
        return predictions

    def __getitem__(self, idx):
        sample_info = self.annotation_db[idx]
        sample_info = self.preprocess_sample_info(sample_info)
        current_sample = Sample()
        current_sample.question_id = np.int32(sample_info["question_id"])
        if isinstance(sample_info["image_id"], int):
            current_sample.image_id = str(sample_info["image_id"])
        else:
            current_sample.image_id = sample_info["image_id"]
        if self._use_features:
            features = self.features_db[idx]
            current_sample.update(features)
        current_sample = self.add_sample_details(sample_info, current_sample)
        current_sample = self.add_answer_info(sample_info, current_sample)
        # only max_features of the feature infos: they batch
        for info_key in ("image_info_0", "image_info_1"):
            if info_key in current_sample:
                info = current_sample[info_key]
                current_sample[info_key] = Sample(
                    {"max_features": info["max_features"]}
                )
        return current_sample

    def add_sample_details(self, sample_info, sample):
        sample.image_id = object_to_byte_tensor(sample.image_id)

        question_str = sample_info.get(
            "question", sample_info.get("question_str")
        )
        text_processor_args = {"text": question_str}
        if "question_tokens" in sample_info:
            text_processor_args["tokens"] = sample_info["question_tokens"]
        processed_question = self.text_processor(text_processor_args)
        if "input_ids" in processed_question:
            sample.text = processed_question["input_ids"]
            sample.text_len = np.int64(len(processed_question["tokens"]))
        else:
            sample.text = processed_question["text"]
            sample.text_len = processed_question["length"]

        if "obj_normalized_boxes" in sample_info and hasattr(
                self, "copy_processor"):
            sample.obj_bbox_coordinates = self.copy_processor(
                {"blob": sample_info["obj_normalized_boxes"]}
            )["blob"]

        if not self.use_ocr:
            sample_info["ocr_tokens"] = []
            sample_info["ocr_info"] = []
            if "ocr_normalized_boxes" in sample_info:
                sample_info["ocr_normalized_boxes"] = np.zeros(
                    (0, 4), np.float32
                )
            if "image_feature_1" in sample:
                sample.image_feature_1 = np.zeros_like(
                    sample.image_feature_1
                )
            return sample

        if hasattr(self, "ocr_token_processor"):
            ocr_tokens = [
                self.ocr_token_processor({"text": token})["text"]
                for token in sample_info["ocr_tokens"]
            ]
        else:
            ocr_tokens = sample_info["ocr_tokens"]

        context = self.context_processor({"tokens": ocr_tokens})
        sample.context = context["text"]
        sample.ocr_tokens = context["tokens"]
        sample.context_tokens = object_to_byte_tensor(context["tokens"])
        sample.context_feature_0 = context["text"]
        sample.context_info_0 = Sample({"max_features": context["length"]})

        if hasattr(self, "phoc_processor"):
            context_phoc = self.phoc_processor({"tokens": ocr_tokens})
            sample.context_feature_1 = context_phoc["text"]
            sample.context_info_1 = Sample(
                {"max_features": context_phoc["length"]}
            )

        if self.config.get("use_order_vectors", False):
            order_vectors = np.eye(len(sample.ocr_tokens), dtype=np.float32)
            order_vectors[int(context["length"]):] = 0
            sample.order_vectors = order_vectors

        if "ocr_normalized_boxes" in sample_info and hasattr(
                self, "copy_processor"):
            max_len = self.config["processors"]["answer_processor"][
                "params"]["max_length"]
            sample.ocr_bbox_coordinates = self.copy_processor(
                {"blob": sample_info["ocr_normalized_boxes"]}
            )["blob"][:max_len]
        elif self.use_ocr_info and "ocr_info" in sample_info:
            sample.ocr_bbox_coordinates = self.bbox_processor(
                {"info": sample_info["ocr_info"]}
            )["bbox"]
        return sample

    def add_answer_info(self, sample_info, sample):
        answers = sample_info.get("answers", [])
        answer_processor_arg = {"answers": answers,
                                "tokens": sample.pop("ocr_tokens", [])}
        processed_answers = self.answer_processor(answer_processor_arg)
        assert not self.config.get("fast_read", False), (
            "In TextVQADataset, online OCR sampling is incompatible with "
            "fast_read"
        )
        sample.update(processed_answers)
        sample.answers = object_to_byte_tensor(answers)
        if "answers_scores" in sample:
            sample.targets = sample.pop("answers_scores")
        return sample
