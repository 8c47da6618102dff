"""BERT tokenizer processors.

Port of ``masked_token``, ``bert_tokenizer``, ``vilt_text_tokenizer``,
``uniter_text_tokenizer`` and ``vinvl_text_tokenizer`` from
``mmf_tpu/datasets/processors/bert_processors.py``. JAX wraps Hugging
Face's ``BertTokenizerFast``; the port has its own WordPiece tokenizer in
plain Python (``BertWordPieceTokenizer``), written to give the same
tokens: the special tokens are matched in the raw text first; then the
text is cleaned (control and format characters removed, whitespace made
spaces), CJK characters are padded with spaces, and, with
``do_lower_case``, accents are stripped (NFD, nonspacing marks dropped)
and the text lowercased character by character; it is split on
whitespace and each punctuation character stands alone; each word then
takes the longest vocabulary match first, continuations prefixed
``##``, and a word that does not decompose, or is over 100 characters,
is ``[UNK]``. The vocabulary is ``tokenizer_config.params.vocab_file``
(a BERT ``vocab.txt``); a tokenizer name alone raises, since the port
downloads nothing. Outputs keep JAX's truncation, padding to
``max_seq_length`` and fields: ``input_ids``, ``input_mask``,
``segment_ids``, ``lm_label_ids`` and ``tokens``.
"""

from __future__ import annotations

import os
import random
import unicodedata
from typing import Any, Dict, List, Union

import numpy as np

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.processors.processors import BaseProcessor

_REMOVED_CATEGORIES = ("Cc", "Cf", "Cn", "Co", "Cs")
# CJK Unified Ideographs and their extensions, and the compatibility
# ideographs: the ranges BERT pads with spaces
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_removed(c: str) -> bool:
    if c in "\t\n\r":
        return False
    return (c in "\x00\ufffd"
            or unicodedata.category(c) in _REMOVED_CATEGORIES)


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punctuation(c: str) -> bool:
    cp = ord(c)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(c).startswith("P")


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """A BERT ``vocab.txt``: one token a line, its index the line's."""
    vocab = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for index, token in enumerate(f):
            vocab[token.rstrip("\n")] = index
    return vocab


class BertWordPieceTokenizer:
    """BERT's basic tokenization and WordPiece over ``vocab_file``."""

    SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 strip_accents=None, tokenize_chinese_chars: bool = True,
                 unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.strip_accents = (do_lower_case if strip_accents is None
                              else strip_accents)
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word
        # longest first, so that no special token shadows a longer one
        self._specials = sorted((t for t in self.SPECIAL_TOKENS
                                 if t in self.vocab), key=len, reverse=True)

    def __len__(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for segment, special in self._split_specials(text):
            if special:
                tokens.append(segment)
                continue
            for word in self._pre_tokenize(self._normalize(segment)):
                tokens.extend(self._wordpiece(word))
        return tokens

    def _split_specials(self, text: str):
        """(segment, is_special) in order: the special tokens as they
        stand in the raw text, leftmost first."""
        start = i = 0
        while i < len(text):
            match = next((t for t in self._specials
                          if text.startswith(t, i)), None)
            if match is None:
                i += 1
                continue
            if i > start:
                yield text[start:i], False
            yield match, True
            i = start = i + len(match)
        if start < len(text):
            yield text[start:], False

    def _normalize(self, text: str) -> str:
        text = "".join(" " if c in "\t\n\r" or c.isspace() else c
                       for c in text if not _is_removed(c))
        if self.tokenize_chinese_chars:
            text = "".join(f" {c} " if _is_cjk(c) else c for c in text)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.do_lower_case:
            text = "".join(c.lower() for c in text)
        return text

    @staticmethod
    def _pre_tokenize(text: str) -> List[str]:
        words = []
        for chunk in text.split():
            word = ""
            for c in chunk:
                if _is_punctuation(c):
                    if word:
                        words.append(word)
                        word = ""
                    words.append(c)
                else:
                    word += c
            if word:
                words.append(word)
        return words

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                candidate = word[start:end]
                if start > 0:
                    candidate = "##" + candidate
                if candidate in self.vocab:
                    piece = candidate
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def convert_tokens_to_ids(self, tokens: Union[str, List[str]]):
        unk = self.vocab.get(self.unk_token)
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Union[int, List[int]]):
        if isinstance(ids, int):
            return self.ids_to_tokens[ids]
        return [self.ids_to_tokens[i] for i in ids]


def build_bert_tokenizer(tokenizer_config) -> BertWordPieceTokenizer:
    """The tokenizer over ``tokenizer_config.params.vocab_file`` (or
    ``tokenizer_config.vocab_file``), the other params passed on."""
    params = dict(tokenizer_config.get("params", {}) or {})
    vocab_file = params.pop("vocab_file", None) or tokenizer_config.get(
        "vocab_file", None)
    name = tokenizer_config.get("type", "bert-base-uncased")
    if vocab_file is None:
        raise ValueError(
            f"tokenizer {name!r} is a name, and the port downloads nothing: "
            "give its vocab.txt as tokenizer_config.params.vocab_file"
        )
    if not os.path.exists(vocab_file):
        raise FileNotFoundError(
            f"tokenizer {name!r}: vocab_file {vocab_file} does not exist")
    return BertWordPieceTokenizer(vocab_file, **params)


@registry.register_processor("masked_token")
class MaskedTokenProcessor(BaseProcessor):
    """Tokenize, then BERT's masked-LM 80/10/10 masking
    (reference bert_processors.py:18-175)."""

    _CLS_TOKEN = "[CLS]"
    _SEP_TOKEN = "[SEP]"
    _MASK_TOKEN = "[MASK]"
    _PAD_TOKEN_ID = 0

    def __init__(self, config, *args, **kwargs):
        tokenizer_config = config.get("tokenizer_config", {})
        self._tokenizer = build_bert_tokenizer(tokenizer_config)
        self._max_seq_length = config.get("max_seq_length", 128)
        self._probability = config.get("mask_probability", 0.15)

    def get_vocab_size(self) -> int:
        return len(self._tokenizer)

    def tokenize(self, tokens: str) -> List[str]:
        return self._tokenizer.tokenize(tokens)

    def _convert_tokens_to_ids(self, tokens):
        return self._tokenizer.convert_tokens_to_ids(tokens)

    def _random_word(self, tokens: List[str], probability: float = 0.15):
        labels = []
        for idx, token in enumerate(tokens):
            prob = random.random()
            if prob < probability:
                prob /= probability
                if prob < 0.8:
                    tokens[idx] = self._MASK_TOKEN
                elif prob < 0.9:
                    tokens[idx] = self._tokenizer.convert_ids_to_tokens(
                        int(np.random.randint(self.get_vocab_size()))
                    )
                # 10% keep
                labels.append(self._convert_tokens_to_ids(token))
            else:
                labels.append(-1)
        return tokens, labels

    def _truncate_seq_pair(self, tokens_a, tokens_b, max_length):
        if tokens_b is None:
            tokens_b = []
            max_length -= 2
        else:
            max_length -= 3
        if max_length < 0:
            raise ValueError(
                "Max length should be minimum 2 in case of single sentence "
                "and 3 in case of two sentences."
            )
        while len(tokens_a) + len(tokens_b) > max_length:
            if len(tokens_a) > len(tokens_b):
                tokens_a.pop()
            else:
                tokens_b.pop()

    def _convert_to_indices(self, tokens_a, tokens_b=None,
                            probability: float = 0.15) -> Dict[str, Any]:
        tokens_a, label_a = self._random_word(tokens_a,
                                              probability=probability)
        tokens = [self._CLS_TOKEN] + tokens_a + [self._SEP_TOKEN]
        segment_ids = [0] * len(tokens)
        lm_label_ids = [-1] + label_a + [-1]

        if tokens_b is not None:
            tokens_b, label_b = self._random_word(
                tokens_b, probability=probability
            )
            if not tokens_b:
                raise ValueError("text_b tokenized to no tokens")
            tokens += tokens_b + [self._SEP_TOKEN]
            segment_ids += [1] * len(tokens_b) + [1]
            lm_label_ids += label_b + [-1]

        input_ids = self._convert_tokens_to_ids(tokens)
        input_mask = [1] * len(input_ids)
        while len(input_ids) < self._max_seq_length:
            input_ids.append(self._PAD_TOKEN_ID)
            input_mask.append(0)
            segment_ids.append(0)
            lm_label_ids.append(-1)

        return {
            "input_ids": np.asarray(input_ids, np.int64),
            "input_mask": np.asarray(input_mask, np.int64),
            "segment_ids": np.asarray(segment_ids, np.int64),
            "lm_label_ids": np.asarray(lm_label_ids, np.int64),
            "tokens": tokens,
        }

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        text_a = item["text_a"]
        text_b = item.get("text_b", None)
        tokens_a = self.tokenize(text_a)
        tokens_b = None
        if text_b:
            tokens_b = self.tokenize(text_b)
        self._truncate_seq_pair(tokens_a, tokens_b, self._max_seq_length)
        output = self._convert_to_indices(
            tokens_a, tokens_b, probability=self._probability
        )
        # the ITM target rides along with the masked pair
        output["is_correct"] = np.int64(item.get("is_correct", True))
        return output


@registry.register_processor("bert_tokenizer")
class BertTokenizer(MaskedTokenProcessor):
    """Tokenization without masking (mask probability 0)
    (reference bert_processors.py:178-211)."""

    def __init__(self, config, *args, **kwargs):
        super().__init__(config, *args, **kwargs)
        self._probability = config.get("mask_probability", 0)

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        if "text" in item:
            text_a = item["text"]
        elif "text_a" in item:
            text_a = item["text_a"]
        else:
            text_a = " ".join(item["tokens"])
        if isinstance(text_a, list):
            text_a = " ".join(text_a)
        tokens_a = self.tokenize(text_a)

        tokens_b = None
        if "text_b" in item and item["text_b"]:
            tokens_b = self.tokenize(item["text_b"])
        self._truncate_seq_pair(tokens_a, tokens_b, self._max_seq_length)
        output = self._convert_to_indices(
            tokens_a, tokens_b, probability=self._probability
        )
        output["text"] = output["tokens"]
        return output


@registry.register_processor("vilt_text_tokenizer")
class VILTTextTokenizer(MaskedTokenProcessor):
    """ViLT's question tokenizer (reference bert_processors.py:409-433):
    one sentence, masked at ``mask_probability`` (0 by default), ``text``
    set to its tokens."""

    def __init__(self, config, *args, **kwargs):
        super().__init__(config, *args, **kwargs)
        self._probability = config.get("mask_probability", 0)

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        if "text" in item:
            text_a = item["text"]
        else:
            text_a = " ".join(item["tokens"])
        tokens_a = self.tokenize(text_a)
        self._truncate_seq_pair(tokens_a, None, self._max_seq_length)
        output = self._convert_to_indices(tokens_a, None,
                                          probability=self._probability)
        output["text"] = output["tokens"]
        return output


@registry.register_processor("uniter_text_tokenizer")
class UNITERTextTokenizer(MaskedTokenProcessor):
    """UNITER's tokenizer (reference bert_processors.py:434-523): one
    sentence twice, masked at ``mask_probability`` (0 by default) and
    plain. The plain ids are ``input_ids``; the masked ones
    ``input_ids_masked`` with their ``lm_label_ids``, for the ``mlm``
    task. The masked pass draws first, as in JAX."""

    def __init__(self, config, *args, **kwargs):
        super().__init__(config, *args, **kwargs)
        self._probability = config.get("mask_probability", 0)

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        if "text" in item:
            text_a = item["text"]
        else:
            text_a = " ".join(item["tokens"])
        tokens_a = self.tokenize(text_a)
        self._truncate_seq_pair(tokens_a, None, self._max_seq_length)
        masked = self._convert_to_indices(list(tokens_a), None,
                                          probability=self._probability)
        unmasked = self._convert_to_indices(list(tokens_a), None,
                                            probability=0.0)
        output = dict(unmasked)
        output["input_ids_masked"] = masked["input_ids"]
        output["lm_label_ids"] = masked["lm_label_ids"]
        output["text"] = output["tokens"]
        return output


@registry.register_processor("vinvl_text_tokenizer")
class VinVLTextTokenizer(MaskedTokenProcessor):
    """VinVL's caption and object-tag pair (reference
    bert_processors.py:524-653): ``text`` (or ``text_a``) and the tags
    ``text_b`` tokenized as a pair, masked at ``mask_probability``; the
    masked ids are ``input_ids_masked`` and the unmasked sequence
    ``input_ids``. With ``corrupt_probability`` above 0, a second pair,
    drawn with numpy: kept (label 0), its caption swapped for one of
    ``random_captions`` (1, at ``corrupt_caption_probability`` of the
    corruptions) or its tags for one of ``random_labels`` (2), gives the
    ``*_corrupt`` inputs and ``contrastive_label`` (and, as JAX emits
    both, ``contrastive_labels``, the key the model reads)."""

    def __init__(self, config, *args, **kwargs):
        super().__init__(config, *args, **kwargs)
        self._max_seq_length = config.get("max_seq_length", 70)
        self._probability = config.get("mask_probability", 0)
        self._corrupt_prob = config.get("corrupt_probability", 0)
        self._corrupt_caption_prob = config.get(
            "corrupt_caption_probability", 0)

    def _pair_output(self, item):
        text_a = item.get("text", item.get("text_a", ""))
        text_b = item.get("text_b", None)
        if isinstance(text_a, list):
            text_a = " ".join(text_a)
        tokens_a = self.tokenize(text_a)
        tokens_b = self.tokenize(text_b) if text_b else None
        self._truncate_seq_pair(tokens_a, tokens_b, self._max_seq_length)
        output = self._convert_to_indices(
            list(tokens_a),
            list(tokens_b) if tokens_b is not None else None,
            probability=self._probability)
        output["input_ids_masked"] = output["input_ids"]
        output["tokens_masked"] = output["tokens"]
        plain = [self._CLS_TOKEN] + tokens_a + [self._SEP_TOKEN]
        if tokens_b:
            plain += tokens_b + [self._SEP_TOKEN]
        ids = self._convert_tokens_to_ids(plain)
        ids += [self._PAD_TOKEN_ID] * (self._max_seq_length - len(ids))
        output["input_ids"] = np.asarray(ids, np.int64)
        output["text"] = output["tokens_masked"]
        return output

    def _contrastive_output(self, item):
        for key in ("random_captions", "random_labels", "text_b"):
            if key not in item:
                raise KeyError(
                    f"'{key}' is required for VinVL contrastive corruption;"
                    " set corrupt_probability to 0 to disable")
        p_match = 1 - self._corrupt_prob
        p_caption = self._corrupt_prob * self._corrupt_caption_prob
        p_label = self._corrupt_prob * (1 - self._corrupt_caption_prob)
        label = int(np.random.choice(3, p=[p_match, p_caption, p_label]))
        corrupt_item = dict(item)
        if label == 1:
            corrupt_item["text"] = random.choice(item["random_captions"])
        elif label == 2:
            corrupt_item["text_b"] = random.choice(item["random_labels"])
        return label, self._pair_output(corrupt_item)

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        output = self._pair_output(item)
        if self._corrupt_prob > 0:
            label, corrupt = self._contrastive_output(item)
            output["input_ids_corrupt"] = corrupt["input_ids"]
            output["segment_ids_corrupt"] = corrupt["segment_ids"]
            output["input_mask_corrupt"] = corrupt["input_mask"]
            output["contrastive_label"] = np.int64(label)
            output["contrastive_labels"] = np.int64(label)
        return output
