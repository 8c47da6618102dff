"""Core processors.

Port of the processors of ``mmf_tpu/datasets/processors/processors.py``
that the VQA2 path builds: the ``Processor`` wrapper (type + params
dispatch through the registry), ``vqa_answer`` (soft VQA-accuracy
scores over the answer vocabulary), ``simple_word``,
``simple_sentence`` and ``bbox``, and ``fasttext``'s constructor (the
VQA2 defaults name it; calling it raises, since no fasttext model ships
with the port). They run on the host and emit fixed-shape numpy arrays.
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.utils.text import VocabDict, tokenize, word_tokenize

logger = logging.getLogger(__name__)


class BaseProcessor:
    """(reference processors.py:102-127)"""

    def __init__(self, *args, config=None, **kwargs):
        return

    def __call__(self, item, *args, **kwargs):
        return item


class Processor:
    """Type+params dispatch wrapper with attribute passthrough
    (reference processors.py:130-177)."""

    def __init__(self, config, *args, **kwargs):
        if "type" not in config:
            raise AttributeError(
                "Processor config needs a 'type' key naming a registered processor"
            )
        processor_class = registry.get_processor_class(config["type"])
        if processor_class is None:
            raise ValueError(
                f"Unknown processor type {config['type']!r}: nothing is "
                f"registered under that key"
            )
        params = {}
        if "params" not in config:
            logger.warning(
                f"Processor '{config['type']}' configured without a "
                "'params' block; instantiating with defaults"
            )
        else:
            params = config["params"]
        self.processor = processor_class(params, *args, **kwargs)
        self._dir_representation = dir(self)

    def __call__(self, item, *args, **kwargs):
        return self.processor(item, *args, **kwargs)

    def __getattr__(self, name):
        # reached only when normal attribute lookup fails: delegate to
        # the wrapped processor instance
        wrapped = self.__dict__.get("processor")
        if wrapped is not None and hasattr(wrapped, name):
            return getattr(wrapped, name)
        raise AttributeError(
            f"Neither the wrapper nor the wrapped processor has {name!r}"
        )


@registry.register_processor("fasttext")
class FastTextProcessor(BaseProcessor):
    """FastText word vectors (reference processors.py:407-532). Built
    lazily, as in JAX: the model file is needed only when the processor
    is called, and the port has no fasttext reader yet, so a call
    raises."""

    def __init__(self, config, *args, **kwargs):
        self.config = config
        self.max_length = config.get("max_length", 50)
        self.model_file = config.get("model_file", None)

    def __call__(self, item):
        raise NotImplementedError(
            f"fasttext ({self.model_file}): the port has no fasttext "
            "reader yet; only configs that never call this processor run"
        )


@registry.register_processor("vqa_answer")
class VQAAnswerProcessor(BaseProcessor):
    """Soft VQA-accuracy answer scores (reference processors.py:535-719)."""

    DEFAULT_NUM_ANSWERS = 10

    def __init__(self, config, *args, **kwargs):
        if "vocab_file" not in config:
            raise AttributeError(
                "Answer processors need 'vocab_file' in their config"
            )
        self.answer_vocab = VocabDict(
            config["vocab_file"], kwargs.get("data_dir", None)
        )
        self.PAD_IDX = self.answer_vocab.word2idx("<pad>")
        self.BOS_IDX = self.answer_vocab.word2idx("<s>")
        self.EOS_IDX = self.answer_vocab.word2idx("</s>")
        self.UNK_IDX = self.answer_vocab.UNK_INDEX
        if self.EOS_IDX == self.UNK_IDX:
            self.EOS_IDX = len(self.answer_vocab)

        self.preprocessor = None
        if "preprocessor" in config:
            self.preprocessor = Processor(config["preprocessor"])
        self.num_answers = config.get("num_answers", self.DEFAULT_NUM_ANSWERS)

    def __call__(self, item):
        tokens = []
        if not isinstance(item, dict):
            raise TypeError("Answer processor input must be a dict")
        if "answer_tokens" in item:
            tokens = item["answer_tokens"]
        elif "answers" in item and item["answers"] is not None:
            if self.preprocessor is None:
                raise AssertionError(
                    "Raw 'answers' need a configured preprocessor; pass "
                    "'answer_tokens' to skip preprocessing"
                )
            tokens = [
                self.preprocessor({"text": answer})["text"]
                for answer in item["answers"]
            ]
        else:
            raise AssertionError(
                "Answer processor input carries neither 'answers' nor "
                "'answer_tokens'"
            )
        if len(tokens) != 0:
            tokens = self._increase_to_ten(tokens)
        answers_indices = np.full(
            self.DEFAULT_NUM_ANSWERS, self.answer_vocab.get_unk_index(),
            np.int64,
        )
        for idx, token in enumerate(tokens):
            answers_indices[idx] = self.answer_vocab.word2idx(token)
        answers_scores = self.compute_answers_scores(answers_indices)
        return {
            "answers": tokens,
            "answers_indices": answers_indices,
            "answers_scores": answers_scores,
        }

    def get_vocab_size(self):
        return self.answer_vocab.num_vocab

    def get_true_vocab_size(self):
        return self.answer_vocab.num_vocab

    def word2idx(self, word):
        return self.answer_vocab.word2idx(word)

    def idx2word(self, idx):
        return self.answer_vocab.idx2word(idx)

    def compute_answers_scores(self, answers_indices):
        """Soft VQA-accuracy target per vocab index (the contract of
        reference processors.py:686-713, in closed form).

        The VQA metric averages, over the 10 annotators, the leave-one-
        out accuracy min(1, matches_among_other_9 / 3). With c = count
        of a candidate among the 10 answers, each of the c annotators
        who gave it sees c-1 matches and each of the 10-c others sees
        c, so the average collapses to a function of c alone."""
        scores = np.zeros(self.get_vocab_size(), np.float32)
        indices = [int(i) for i in answers_indices]
        n = len(indices)
        for answer, c in Counter(indices).items():
            if answer == self.answer_vocab.UNK_INDEX:
                continue
            held_in = min(1.0, (c - 1) / 3.0)
            held_out = min(1.0, c / 3.0)
            scores[answer] = (c * held_in + (n - c) * held_out) / n
        return scores

    def _increase_to_ten(self, tokens):
        while len(tokens) < self.DEFAULT_NUM_ANSWERS:
            tokens += tokens[: self.DEFAULT_NUM_ANSWERS - len(tokens)]
        return tokens


@registry.register_processor("simple_word")
class SimpleWordProcessor(BaseProcessor):
    """(reference processors.py:1054-1069)"""

    def __init__(self, *args, **kwargs):
        self.tokenizer = word_tokenize

    def __call__(self, item, *args, **kwargs):
        return {"text": self.tokenizer(item["text"], *args, **kwargs)}


@registry.register_processor("simple_sentence")
class SimpleSentenceProcessor(BaseProcessor):
    """(reference processors.py:1072-1087)"""

    def __init__(self, *args, **kwargs):
        self.tokenizer = tokenize

    def __call__(self, item, *args, **kwargs):
        return {"text": self.tokenizer(item["text"], *args, **kwargs)}


@registry.register_processor("bbox")
class BBoxProcessor(BaseProcessor):
    """imdb bbox -> padded normalized array (reference processors.py:1090)."""

    def __init__(self, config, *args, **kwargs):
        self.max_length = config.get("max_length", 50)

    def __call__(self, item):
        info = item["info"]
        bbox = np.zeros((self.max_length, 4), np.float32)
        n = min(len(info["bbox"]), self.max_length)
        bbox[:n] = np.asarray(info["bbox"], np.float32)[:n]
        return {"bbox": bbox}
