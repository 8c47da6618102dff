"""Text utilities: tokenization, vocabulary dictionaries, the caption
decoders and the sampling stream of stochastic decoders.

Port of ``mmf_tpu/utils/text.py``: ``tokenize``, ``word_tokenize``,
``load_str_list``, ``VocabDict`` and the registered host-side decoders
``beam_search`` and ``nucleus_sampling`` (numpy state, one step at a
time on a model's scores; BUTD decodes inside its forward, at a fixed
number of steps). ``sampling_generator`` installs the
``torch.Generator`` that BUTD's nucleus sampling draws from (JAX's
``"sampling"`` rng collection; the trainer gives each evaluation batch a
fresh one).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
from typing import List, Optional

import numpy as np
import torch

from mmf_tpu_torch.common.registry import registry

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")


def tokenize(sentence: str, regex=SENTENCE_SPLIT_REGEX, keep=None,
             remove=None) -> List[str]:
    if keep is None:
        keep = ["'s"]
    if remove is None:
        remove = [",", "?"]
    sentence = sentence.lower()
    for token in keep:
        sentence = sentence.replace(token, " " + token)
    for token in remove:
        sentence = sentence.replace(token, "")
    tokens = regex.split(sentence)
    return [t.strip() for t in tokens if len(t.strip()) > 0]


def word_tokenize(word: str, remove=None) -> str:
    if remove is None:
        remove = [",", "?"]
    word = word.lower()
    for item in remove:
        word = word.replace(item, "")
    word = word.replace("'s", " 's")
    return word.strip()


def load_str_list(fname: str) -> List[str]:
    with open(fname) as f:
        return [line.strip() for line in f.readlines()]


class VocabDict:
    UNK_TOKEN = "<unk>"
    PAD_TOKEN = "<pad>"
    START_TOKEN = "<s>"
    END_TOKEN = "</s>"

    PAD_INDEX = 0
    SOS_INDEX = 1
    EOS_INDEX = 2
    UNK_INDEX = 3

    def __init__(self, vocab_file: Optional[str] = None, data_dir=None,
                 word_list: Optional[List[str]] = None):
        if word_list is not None:
            self.word_list = list(word_list)
            self._build()
            return
        if not os.path.exists(vocab_file) and data_dir is not None:
            from mmf_tpu_torch.utils.general import get_absolute_path

            vocab_file = get_absolute_path(os.path.join(data_dir, vocab_file))
        if not os.path.exists(vocab_file):
            raise RuntimeError(
                f"no vocab file at {vocab_file}"
            )
        self.word_list = load_str_list(vocab_file)
        self._build()

    def _build(self):
        if self.UNK_TOKEN not in self.word_list:
            self.word_list = [self.UNK_TOKEN] + self.word_list
        self.word2idx_dict = {w: i for i, w in enumerate(self.word_list)}
        self.stoi = self.word2idx_dict
        self.itos = self.word_list
        self.num_vocab = len(self.word_list)
        self.UNK_INDEX = self.word2idx_dict.get(self.UNK_TOKEN, None)
        self.PAD_INDEX = self.word2idx_dict.get(self.PAD_TOKEN, None)

    def idx2word(self, n_w: int) -> str:
        return self.word_list[n_w]

    def __len__(self): return len(self.word_list)

    def get_size(self) -> int:
        return len(self.word_list)

    def get_unk_index(self): return self.UNK_INDEX

    def get_unk_token(self): return self.UNK_TOKEN

    def word2idx(self, w: str) -> int:
        if w in self.word2idx_dict:
            return self.word2idx_dict[w]
        if self.UNK_INDEX is not None:
            return self.UNK_INDEX
        raise ValueError(
            f"word {w} not in dictionary (while dictionary does not "
            "contain <unk>)"
        )

    def tokenize_and_index(self, sentence: str) -> List[int]:
        return [self.word2idx(w) for w in tokenize(sentence)]


_SAMPLING_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "mmf_sampling_generator", default=None)


@contextlib.contextmanager
def sampling_generator(generator: Optional[torch.Generator]):
    """Install ``generator`` as the source of the draws of stochastic
    decoders inside the block."""
    token = _SAMPLING_GENERATOR.set(generator)
    try:
        yield generator
    finally:
        _SAMPLING_GENERATOR.reset(token)


def current_sampling_generator(device) -> torch.Generator:
    """The installed generator, else a fresh one seeded 0 on ``device``
    (JAX's ``PRNGKey(0)`` when no ``"sampling"`` rng is given)."""
    g = _SAMPLING_GENERATOR.get()
    if g is None:
        g = torch.Generator(device=device).manual_seed(0)
    return g


class TextDecoder:
    """Base class of the decoding strategies."""

    def __init__(self, vocab):
        self._vocab = vocab
        self._vocab_size = vocab.get_size()

    def init_batch(self, sample_list):
        raise NotImplementedError

    def decode(self, t, data, scores):
        raise NotImplementedError


@registry.register_decoder("beam_search")
class BeamSearch(TextDecoder):
    """Beam search over one sample's beams, on the host: each step takes
    [beams, vocab] raw logits, adds their log-softmax to the beams'
    scores, keeps the best ``beam_length`` continuations (from beam 0
    alone at step 0), moves the ones that end on EOS to the finished
    list and returns ``(finished, data, kept beams)``."""

    def __init__(self, vocab, config):
        super().__init__(vocab)
        self._decode_size = config["inference"]["params"]["beam_length"]

    def init_batch(self, sample_list):
        self.seqs = np.full((self._decode_size, 1), self._vocab.SOS_INDEX,
                            dtype=np.int64)
        self.top_k_scores = np.zeros((self._decode_size, 1), np.float32)
        self.complete_seqs = []
        self.complete_seqs_scores = []
        return sample_list

    def decode(self, t, data, scores):
        scores = np.asarray(scores, np.float64)
        top = scores.max(-1, keepdims=True)
        scores = scores - np.log(np.sum(np.exp(scores - top), -1,
                                        keepdims=True)) - top
        scores = scores.astype(np.float32) + self.top_k_scores
        k = self.seqs.shape[0]
        flat = scores[0] if t == 0 else scores.reshape(-1)
        top_idx = np.argsort(-flat)[:k]
        self.top_k_scores = flat[top_idx][:, None]
        prev_beam = (top_idx // self._vocab_size if t > 0
                     else np.zeros(k, np.int64))
        next_word = top_idx % self._vocab_size
        self.seqs = np.concatenate([self.seqs[prev_beam], next_word[:, None]],
                                   axis=1)
        incomplete = next_word != self._vocab.EOS_INDEX
        for ci in np.where(~incomplete)[0]:
            self.complete_seqs.append(self.seqs[ci].tolist())
            self.complete_seqs_scores.append(float(self.top_k_scores[ci, 0]))
        keep = np.where(incomplete)[0]
        self.seqs = self.seqs[keep]
        self.top_k_scores = self.top_k_scores[keep]
        return len(keep) == 0, data, keep

    def get_result(self):
        if len(self.complete_seqs_scores) == 0:
            if len(self.seqs) > 0:
                return np.asarray([self.seqs[0].tolist()])
            return np.zeros((1, 1), np.int64)
        best = int(np.argmax(self.complete_seqs_scores))
        return np.asarray([self.complete_seqs[best]])


@registry.register_decoder("nucleus_sampling")
class NucleusSampling(TextDecoder):
    """Top-p sampling of one sequence on the host: each step draws the
    next word from the smallest set of words whose probability reaches
    ``sum_threshold``, renormalised (numpy's generator, seeded 0)."""

    def __init__(self, vocab, config):
        super().__init__(vocab)
        self._threshold = config["inference"]["params"]["sum_threshold"]
        self._rng = np.random.default_rng(0)
        self.seq = []

    def init_batch(self, sample_list):
        self.seq = []
        return sample_list

    def decode(self, t, data, scores):
        probs = np.exp(np.asarray(scores[0], np.float64))
        probs = probs / probs.sum()
        order = np.argsort(-probs)
        cum = np.cumsum(probs[order])
        cutoff = int(np.searchsorted(cum, self._threshold)) + 1
        cand = order[:cutoff]
        cand_p = probs[cand] / probs[cand].sum()
        next_word = int(self._rng.choice(cand, p=cand_p))
        self.seq.append(next_word)
        finished = next_word == self._vocab.EOS_INDEX
        return finished, data, np.asarray([0] if not finished else [])

    def get_result(self):
        return np.asarray([self.seq])
