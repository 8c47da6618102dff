"""The masked VQA2 pretraining datasets.

Port of ``mmf_tpu/datasets/builders/vqa2/masked_dataset.py``.
``MaskedVQA2Dataset``: the question and one of its ground-truth answers,
drawn with Python's ``random``, form the sentence pair of the masked LM
(``masked_token_processor``), beside the region features with their
masked-region labels. ``MaskedQVQA2Dataset``: a cloze over the question
through a ``vocab`` text processor, one question word swapped for
``<mask>`` and made the classification target.
"""

from __future__ import annotations

import random

import numpy as np

from mmf_tpu_torch.common.sample import Sample
from mmf_tpu_torch.datasets.builders.vqa2.dataset import VQA2Dataset


class MaskedVQA2Dataset(VQA2Dataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        kwargs.setdefault("dataset_name", "masked_vqa2")
        super().__init__(config, dataset_type, imdb_file_index, *args,
                         **kwargs)
        self._add_answer = config.get("add_answer", False)

    def load_item(self, idx):
        sample_info = self.annotation_db[idx]
        current_sample = Sample()
        if self._use_features:
            current_sample = self.add_masked_features(idx, current_sample)
        current_sample = self._add_masked_question(sample_info,
                                                   current_sample)
        if self._add_answer:
            current_sample = self.add_answer_info(sample_info,
                                                  current_sample)
        return current_sample

    def _add_masked_question(self, sample_info, current_sample):
        question = sample_info["question_str"]
        random_answer = random.choice(sample_info["all_answers"])
        processed = self.masked_token_processor(
            {"text_a": question, "text_b": random_answer, "is_correct": -1})
        processed.pop("tokens", None)
        current_sample.update(processed)
        return current_sample


class MaskedQVQA2Dataset(VQA2Dataset):
    """A single-word cloze over the question (reference
    masked_q_vqa2_dataset.py:6-29)."""

    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        kwargs.setdefault("dataset_name", "masked_q_vqa2")
        super().__init__(config, dataset_type, imdb_file_index, *args,
                         **kwargs)

    def add_answer_info(self, sample_info, current_sample):
        length = min(len(current_sample.text), int(current_sample.text_len))
        index = random.randrange(length)
        vocab = self.text_processor.vocab
        word = vocab.get_itos()[int(current_sample.text[index])]
        text = np.array(current_sample.text)
        text[index] = vocab.get_stoi().get("<mask>", vocab.get_unk_index())
        current_sample.text = text

        processed = self.answer_processor({"answers": [word]})
        current_sample.answers = processed["answers"]
        current_sample.targets = processed["answers_scores"]
        if self.answer_processor.word2idx(word) == \
                self.answer_processor.word2idx("<unk>"):
            current_sample.targets = np.zeros_like(current_sample.targets)
        return current_sample
