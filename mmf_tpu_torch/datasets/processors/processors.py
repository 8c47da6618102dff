"""Core processors.

Port of the processors of ``mmf_tpu/datasets/processors/processors.py``
that the VQA2, masked-VQA2 and TextVQA paths build: the ``Processor``
wrapper (type + params dispatch through the registry), ``vqa_answer``
(soft VQA-accuracy scores over the answer vocabulary),
``multi_hot_answer_from_vocab``, ``soft_copy_answer`` (LoRRA's: the
scores and the OCR copy slots' soft accuracies), ``vocab`` (words to
indices through a vocabulary file), ``caption`` (COCO's caption ids back to words),
``simple_word``, ``simple_sentence``, ``bbox``,
``masked_region`` (region masks for masked-region pretraining, drawn
from Python's ``random`` as in JAX) and ``transformer_bbox`` (normalised
box geometry with the area), and M4C's: ``fasttext`` (OCR tokens to
300-d word vectors through a ``fasttext`` model file, loaded at the
first call; without the file or the ``fasttext`` package a call raises,
as in JAX), ``phoc`` (OCR tokens to 604-d PHOC vectors through the C
featurizer), ``copy`` (an array padded to ``max_length``) and
``m4c_answer`` (fixed-vocabulary + OCR-copy decoding targets; the
teacher-forced spelling is drawn from numpy's global generator, as in
JAX) and ``m4c_caption`` (its form for captions). They run on the host
and emit fixed-shape numpy arrays.
"""

from __future__ import annotations

import logging
import os
import random
import re
import warnings
from collections import Counter, defaultdict
from itertools import islice, product

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


@registry.register_processor("multi_hot_answer_from_vocab")
class MultiHotAnswerFromVocabProcessor(VQAAnswerProcessor):
    """A multi-hot target in place of the soft scores (reference
    processors.py:948)."""

    def compute_answers_scores(self, answers_indices):
        scores = np.zeros(self.get_vocab_size(), np.float32)
        scores[np.asarray(answers_indices, np.int64)] = 1
        scores[self.answer_vocab.UNK_INDEX] = 0
        return scores


@registry.register_processor("soft_copy_answer")
class SoftCopyAnswerProcessor(VQAAnswerProcessor):
    """VQA answer scores over the answer vocabulary and ``max_length``
    OCR copy slots (reference processors.py:960-1051): each slot whose
    token (through ``context_preprocessor``) is one of the answers gets
    that answer's soft VQA accuracy. ``get_vocab_size`` counts the
    slots, ``get_true_vocab_size`` the answers alone."""

    DEFAULT_MAX_LENGTH = 50

    def __init__(self, config, *args, **kwargs):
        super().__init__(config, *args, **kwargs)
        self.use_soft_copy = True
        if "max_length" in config:
            self.max_length = config["max_length"]
        else:
            self.max_length = self.DEFAULT_MAX_LENGTH
            warnings.warn(
                "SoftCopyAnswerProcessor: max_length not configured; "
                f"using {self.DEFAULT_MAX_LENGTH} copy slots")
        self.context_preprocessor = None
        if "context_preprocessor" in config:
            self.context_preprocessor = Processor(
                config["context_preprocessor"])

    def get_vocab_size(self):
        return self.answer_vocab.num_vocab + self.max_length

    def get_true_vocab_size(self):
        return self.answer_vocab.num_vocab

    def __call__(self, item):
        processed = super().__call__({"answers": item["answers"]})
        answers, scores = processed["answers"], processed["answers_scores"]
        tokens = item["tokens"]
        length = min(len(tokens), self.max_length)
        if self.context_preprocessor is not None:
            tokens = [self.context_preprocessor({"text": token})["text"]
                      for token in tokens]
        # the closed form of compute_answers_scores, a slot's token
        # counted among the answers
        tokens_scores = np.zeros(self.max_length, np.float32)
        n, counts = len(answers), Counter(answers)
        for slot, token in enumerate(tokens[:length]):
            c = counts[token]
            if c == 0:
                continue
            held_in = min(1.0, (c - 1) / 3.0)
            held_out = min(1.0, c / 3.0)
            tokens_scores[slot] = (c * held_in + (n - c) * held_out) / n
        scores[-len(tokens_scores):] = tokens_scores
        return {"answers": answers,
                "answers_indices": processed["answers_indices"],
                "answers_scores": scores}


@registry.register_processor("vocab")
class VocabProcessor(BaseProcessor):
    """Words to a padded index array through a ``utils.vocab.Vocab``
    (reference processors.py:207-342): ``{"text": indices, "tokens":
    padded tokens, "length": n}``. Subclasses (``fasttext``, ``phoc``)
    keep the call and override ``_map_strings_to_indices``."""

    MAX_LENGTH_DEFAULT = 50
    PAD_TOKEN = "<pad>"

    def __init__(self, config, *args, **kwargs):
        from mmf_tpu_torch.utils.vocab import Vocab

        if not config.get("vocab"):
            raise AttributeError(
                "VocabProcessor needs a 'vocab' block in its config")
        self.vocab = Vocab(*args, **config["vocab"], **kwargs)
        self._init_extras(config, *args, **kwargs)

    def _init_extras(self, config, *args, **kwargs):
        self.max_length = config.get("max_length", self.MAX_LENGTH_DEFAULT)
        self.preprocessor = None
        if "preprocessor" in config:
            self.preprocessor = Processor(config["preprocessor"], *args,
                                          **kwargs)

    def __call__(self, item):
        if not isinstance(item, dict):
            raise TypeError("VocabProcessor input must be a dict carrying "
                            "'text' or 'tokens'")
        if "tokens" in item:
            tokens = item["tokens"]
        elif "text" in item:
            if self.preprocessor is None:
                raise AssertionError(
                    "Raw 'text' input needs a configured preprocessor to "
                    "tokenize it first")
            tokens = self.preprocessor({"text": item["text"]})["text"]
        else:
            raise AssertionError(
                "VocabProcessor input carries neither 'text' nor 'tokens'")
        indices = self._map_strings_to_indices(tokens)
        length = min(len(tokens), self.max_length)
        padded = [self.PAD_TOKEN] * self.max_length
        padded[:length] = tokens[:length]
        return {"text": indices, "tokens": padded, "length": np.int64(length)}

    def _map_strings_to_indices(self, tokens):
        indices = np.full(self.max_length, self.vocab.get_pad_index(),
                          np.int64)
        for idx, token in enumerate(tokens[:self.max_length]):
            indices[idx] = self.vocab.stoi.get(token,
                                               self.vocab.get_unk_index())
        return indices

    def get_pad_index(self):
        return self.vocab.get_pad_index()

    def get_vocab_size(self):
        return self.vocab.get_size()


@registry.register_processor("fasttext")
class FastTextProcessor(VocabProcessor):
    """FastText word vectors, ``[max_length, dim]`` f32 with zero rows
    past the tokens (reference processors.py:407-532). The model file
    (``model_file``, else ``wiki.en.bin`` in ``env.cache_dir``) is
    loaded through the ``fasttext`` package at the first call; a call
    raises when the file or the package is missing (nothing is
    downloaded). ``model`` may be set to any object with
    ``get_word_vector`` and ``get_dimension`` before the first call."""

    def __init__(self, config, *args, **kwargs):
        self.config = config
        self._init_extras(config)
        self.model_file = config.get("model_file", None)
        self.model = None

    def _load_fasttext_model(self, model_file):
        if not os.path.exists(model_file):
            raise RuntimeError(
                f"fasttext model {model_file} not present; nothing is "
                "downloaded: put the file there first")
        import fasttext

        self.model = fasttext.load_model(model_file)

    def _map_strings_to_indices(self, tokens):
        tokens = tokens[:self.max_length]
        output = np.zeros((self.max_length, self.model.get_dimension()),
                          np.float32)
        for idx, token in enumerate(tokens):
            output[idx] = self.model.get_word_vector(token)
        return output

    def __call__(self, item):
        if self.model is None:
            model_file = self.model_file
            if model_file is None:
                from mmf_tpu_torch.config.configuration import get_mmf_env

                model_file = os.path.join(get_mmf_env("cache_dir"),
                                          "wiki.en.bin")
            self._load_fasttext_model(model_file)
        return super().__call__(item)


@registry.register_processor("phoc")
class PhocProcessor(VocabProcessor):
    """PHOC vectors of the OCR tokens, ``[max_length, 604]`` f32
    (reference processors.py:1385), through the C featurizer
    (``utils/phoc``)."""

    def __init__(self, config, *args, **kwargs):
        self.config = config
        self._init_extras(config)

    def _map_strings_to_indices(self, tokens):
        from mmf_tpu_torch.utils.phoc.build_phoc import (
            PHOC_DIM,
            build_phoc_batch,
        )

        tokens = tokens[:self.max_length]
        output = np.zeros((self.max_length, PHOC_DIM), np.float32)
        if tokens:
            output[:len(tokens)] = build_phoc_batch(list(tokens))
        return output


@registry.register_processor("copy")
class CopyProcessor(BaseProcessor):
    """An array padded (or cut) to ``max_length`` rows (reference
    processors.py:1413)."""

    def __init__(self, config, *args, **kwargs):
        self.max_length = config["max_length"]

    def __call__(self, item):
        blob = item["blob"]
        final_blob = np.zeros((self.max_length,) + blob.shape[1:], blob.dtype)
        final_blob[:len(blob)] = blob[:self.max_length]
        return {"blob": final_blob}


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


@registry.register_processor("caption")
class CaptionProcessor(BaseProcessor):
    """Caption ids back to words (reference processors.py:1142-1171): up
    to the first end-of-sentence id, without the start, end and padding
    ids, joined with spaces."""

    def __init__(self, config, *args, **kwargs):
        if not config.get("vocab"):
            raise AttributeError(
                "CaptionProcessor needs a 'vocab' block in its config")
        from mmf_tpu_torch.utils.vocab import Vocab

        self.vocab = Vocab(*args, **config["vocab"], **kwargs)

    def __call__(self, item):
        for idx, v in enumerate(item):
            if v == self.vocab.EOS_INDEX:
                item = item[:idx]
                break
        skip = {self.vocab.SOS_INDEX, self.vocab.EOS_INDEX,
                self.vocab.PAD_INDEX}
        tokens = [self.vocab.get_itos()[int(w)] for w in item
                  if w not in skip]
        return {"tokens": tokens, "caption": " ".join(tokens)}


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


@registry.register_processor("masked_region")
class MaskedRegionProcessor(BaseProcessor):
    """Masks regions for masked-region pretraining (reference
    processors.py:1637-1663): each region is picked with probability
    ``mask_probability``; a picked region is labelled 1 and zeroed with
    probability ``mask_region_probability``, the others are labelled -1.
    The draws come from Python's ``random``, as in JAX, so a seeded run
    masks the same regions in both packages. Returns (features, labels)."""

    def __init__(self, config, *args, **kwargs):
        self.mask_prob = config.get("mask_probability", 0.15)
        self.mask_region_prob = config.get("mask_region_probability", 0.9)

    def __call__(self, item):
        image_feature = np.array(item, copy=True)
        image_labels = []
        for i in range(image_feature.shape[0]):
            prob = random.random()
            if prob < self.mask_prob:
                prob /= self.mask_prob
                if prob < self.mask_region_prob:
                    image_feature[i] = 0
                image_labels.append(1)
            else:
                image_labels.append(-1)
        return image_feature, np.asarray(image_labels, np.int64)


@registry.register_processor("transformer_bbox")
class TransformerBboxProcessor(BaseProcessor):
    """Box geometry for ViLBERT's location embedding (reference
    processors.py:1666-1700): the info dict's boxes become [x1, y1, x2,
    y2, area] normalised by the image's size. Returns a shallow copy with
    ``bbox`` replaced: with ``fast_read`` one cached info dict serves
    every question of an image, and an update in place would normalise
    it again at each use."""

    def __init__(self, config, *args, **kwargs):
        self.bbox_key = config.get("bbox_key", "bbox")
        self.image_width_key = config.get("image_width_key", "image_width")
        self.image_height_key = config.get("image_height_key",
                                           "image_height")

    def __call__(self, item):
        image_w = float(item[self.image_width_key])
        image_h = float(item[self.image_height_key])
        bbox = np.asarray(item[self.bbox_key], np.float32)
        location = np.zeros((bbox.shape[0], 5), np.float32)
        location[:, :4] = bbox[:, :4]
        location[:, 4] = ((location[:, 3] - location[:, 1])
                          * (location[:, 2] - location[:, 0])
                          / (image_w * image_h))
        location[:, (0, 2)] /= image_w
        location[:, (1, 3)] /= image_h
        out = dict(item)
        out["bbox"] = location
        return out


@registry.register_processor("m4c_answer")
class M4CAnswerProcessor(BaseProcessor):
    """Fixed-vocab + OCR-copy decoding targets for M4C (reference
    processors.py:1430-1607): the step-0 soft scores of every spelling
    of every answer, and the teacher-forced input and targets of one
    spelling drawn with ``np.random.choice`` (numpy's global generator,
    as in JAX)."""

    def __init__(self, config, *args, **kwargs):
        self.answer_vocab = VocabDict(
            config["vocab_file"], kwargs.get("data_dir", None)
        )
        self.PAD_IDX = self.answer_vocab.word2idx("<pad>")
        self.BOS_IDX = self.answer_vocab.word2idx("<s>")
        self.EOS_IDX = self.answer_vocab.word2idx("</s>")
        self.UNK_IDX = self.answer_vocab.UNK_INDEX
        assert self.PAD_IDX != self.answer_vocab.UNK_INDEX
        assert self.BOS_IDX != self.answer_vocab.UNK_INDEX
        assert self.EOS_IDX != self.answer_vocab.UNK_INDEX
        assert self.PAD_IDX == 0

        self.answer_preprocessor = Processor(config["preprocessor"])
        self.num_answers = config["num_answers"]
        self.max_length = config["max_length"]
        self.max_copy_steps = config["max_copy_steps"]
        assert self.max_copy_steps >= 1
        self.match_answer_to_unk = False

    def tokenize(self, sentence):
        return sentence.split()

    def match_answer_to_vocab_ocr_seq(self, answer, vocab2idx_dict,
                                      ocr2inds_dict, max_match_num=20):
        """Every way to spell ``answer`` as decoder indices, each word
        from the fixed vocab (index < num_vocab) or copied from any OCR
        slot holding it (num_vocab + slot): the first ``max_match_num``
        in prefix-major order, or [] when a word is spellable neither way
        (reference processors.py:1464-1505)."""
        num_vocab = len(vocab2idx_dict)
        per_word = []
        for word in self.tokenize(answer):
            choices = []
            if word in vocab2idx_dict:
                choices.append(vocab2idx_dict[word])
            choices += [num_vocab + slot for slot in ocr2inds_dict[word]]
            if not choices:
                if not self.match_answer_to_unk:
                    return []
                choices.append(vocab2idx_dict.get("<unk>"))
            per_word.append(choices)
        if not per_word:
            return []
        return list(islice(product(*per_word), max_match_num))

    def get_vocab_size(self):
        return self.answer_vocab.num_vocab + self.max_length

    def get_true_vocab_size(self):
        return self.answer_vocab.num_vocab

    def compute_answer_scores(self, answers):
        """Answer string -> soft VQA accuracy, in closed form over the
        answer multiset (see ``VQAAnswerProcessor.compute_answers_scores``)."""
        n = len(answers)
        scores = {}
        for answer, c in Counter(answers).items():
            held_in = min(1.0, (c - 1) / 3.0)
            held_out = min(1.0, c / 3.0)
            scores[answer] = (c * held_in + (n - c) * held_out) / n
        return scores

    def __call__(self, item):
        answers = item["answers"]
        if not answers:
            return {
                "sampled_idx_seq": None,
                "train_prev_inds": np.zeros(self.max_copy_steps, np.int64),
            }
        answers = [
            self.answer_preprocessor({"text": a})["text"] for a in answers
        ]
        assert len(answers) == self.num_answers
        answer_score = self.compute_answer_scores(answers)

        # OCR token string -> the copy slots it occupies (may repeat)
        ocr_slots = defaultdict(list)
        for slot, token in enumerate(item["tokens"]):
            ocr_slots[token].append(slot)

        # step 0: every spelling's first index earns its answer's soft
        # accuracy (the max over answers sharing a first index)
        scores = np.zeros(
            (self.max_copy_steps, self.get_vocab_size()), np.float32
        )
        candidate_seqs = []
        for answer in answers:
            seqs = self.match_answer_to_vocab_ocr_seq(
                answer, self.answer_vocab.word2idx_dict, ocr_slots
            )
            candidate_seqs += seqs
            for seq in seqs:
                scores[0, seq[0]] = max(scores[0, seq[0]],
                                        answer_score[answer])

        # teacher forcing from ONE uniformly drawn spelling: BOS, then the
        # spelling shifted right; the step after its last index targets EOS
        train_prev_inds = np.zeros(self.max_copy_steps, np.int64)
        train_loss_mask = np.zeros(self.max_copy_steps, np.float32)
        sampled = ()
        if candidate_seqs:
            sampled = candidate_seqs[np.random.choice(len(candidate_seqs))]
            steps = min(1 + len(sampled), self.max_copy_steps)
            train_loss_mask[:steps] = 1.0
            train_prev_inds[0] = self.BOS_IDX
            train_prev_inds[1:steps] = sampled[:steps - 1]
            for t in range(1, steps):
                target = sampled[t] if t < len(sampled) else self.EOS_IDX
                scores[t, target] = 1.0

        return {
            "answers": answers,
            "answers_scores": scores,
            "sampled_idx_seq": sampled,
            "train_prev_inds": train_prev_inds,
            "train_loss_mask": train_loss_mask,
        }


@registry.register_processor("m4c_caption")
class M4CCaptionProcessor(M4CAnswerProcessor):
    """``m4c_answer`` for captions (``mmf_tpu/datasets/processors/
    processors.py:711``): a caption is lower-cased, loses ``,``, ``?``
    and ``.``, splits ``'s`` off and splits on non-word characters; a
    word in neither the vocabulary nor the OCR tokens is spelled
    ``<unk>``; every caption scores 1.0."""

    SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")

    def __init__(self, config, *args, **kwargs):
        super().__init__(config, *args, **kwargs)
        self.match_answer_to_unk = True

    def tokenize(self, sentence):
        sentence = sentence.lower()
        sentence = (sentence.replace(",", "").replace("?", "")
                    .replace(".", "").replace("'s", " 's"))
        tokens = self.SENTENCE_SPLIT_REGEX.split(sentence)
        return [t.strip() for t in tokens if len(t.strip()) > 0]

    def compute_answer_scores(self, answers):
        return {a: 1.0 for a in answers}
