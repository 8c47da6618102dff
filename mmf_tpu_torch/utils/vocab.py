"""Word vocabularies for the ``vocab`` text processor.

Port of the vocabularies of ``mmf_tpu/utils/vocab.py`` that need no
download: ``random`` (a vocabulary file and random-normal vectors) and
``intersected`` (a vocabulary file with the GloVe vectors of its words,
read from ``<data_dir>/vectors/<embedding_name>.txt``). The four special
tokens come first, at the same indices. ``Vocab`` dispatches on
``type``; the other types (custom, pretrained, extracted, model) are not
ported yet and raise.
"""

from __future__ import annotations

import os

import numpy as np


class BaseVocab:
    PAD_TOKEN, SOS_TOKEN, EOS_TOKEN, UNK_TOKEN = "<pad>", "<s>", "</s>", "<unk>"
    PAD_INDEX, SOS_INDEX, EOS_INDEX, UNK_INDEX = 0, 1, 2, 3

    def __init__(self, vocab_file=None, embedding_dim=300, data_dir=None,
                 *args, **kwargs):
        self.type = "random"
        self.itos = {self.PAD_INDEX: self.PAD_TOKEN,
                     self.SOS_INDEX: self.SOS_TOKEN,
                     self.EOS_INDEX: self.EOS_TOKEN,
                     self.UNK_INDEX: self.UNK_TOKEN}
        self.word_dict = {w: i for i, w in self.itos.items()}
        self.total_predefined = len(self.itos)
        if vocab_file is not None:
            if not os.path.isabs(vocab_file) and data_dir is not None:
                vocab_file = os.path.join(data_dir, vocab_file)
            if not os.path.exists(vocab_file):
                raise RuntimeError(f"Vocab not found at {vocab_file}")
            index = len(self.itos)
            with open(vocab_file) as f:
                for line in f:
                    self.itos[index] = line.strip()
                    self.word_dict[line.strip()] = index
                    index += 1
        self.word_dict[self.UNK_TOKEN] = self.UNK_INDEX
        self.stoi = self.word_dict
        self.vectors = np.random.randn(self.get_size(),
                                       embedding_dim).astype(np.float32)

    def get_itos(self):
        return self.itos

    def get_stoi(self):
        return self.stoi

    def get_size(self):
        return len(self.itos)

    def get_pad_index(self):
        return self.PAD_INDEX

    def get_unk_index(self):
        return self.UNK_INDEX

    def get_vectors(self):
        return self.vectors


class IntersectedVocab(BaseVocab):
    """A vocabulary file with the GloVe vectors of the words it shares
    with them (zeros for the others)."""

    def __init__(self, vocab_file, embedding_name, data_dir=None, *args,
                 **kwargs):
        super().__init__(vocab_file, data_dir=data_dir)
        self.type = "intersected"
        vector_file = os.path.join(data_dir or ".", "vectors",
                                   f"{embedding_name}.txt")
        if not os.path.exists(vector_file):
            raise RuntimeError(
                f"Pretrained vectors for {embedding_name} not found at "
                f"{vector_file}; nothing is downloaded, put the file there")
        vecs = {}
        with open(vector_file) as f:
            for line in f:
                parts = line.rstrip().split(" ")
                vecs[parts[0]] = np.asarray([float(x) for x in parts[1:]],
                                            np.float32)
        dim = len(next(iter(vecs.values())))
        self.vectors = np.zeros((self.get_size(), dim), np.float32)
        for i in range(self.total_predefined, self.get_size()):
            if self.itos[i] in vecs:
                self.vectors[i] = vecs[self.itos[i]]


class Vocab:
    """The vocabulary of ``type`` (reference vocab.py:20-75); attribute
    lookups go to it."""

    KINDS = {"random": (BaseVocab, ("vocab_file",)),
             "intersected": (IntersectedVocab,
                             ("vocab_file", "embedding_name"))}

    def __init__(self, *args, **params):
        vocab_type = params.get("type", "pretrained")
        if vocab_type not in self.KINDS:
            raise NotImplementedError(
                f"vocab type {vocab_type!r} is not ported yet (the port has "
                f"{sorted(self.KINDS)})")
        impl, required = self.KINDS[vocab_type]
        missing = [key for key in required if params.get(key) is None]
        if missing:
            raise ValueError(
                f"Vocab type '{vocab_type}' requires {missing} in params")
        self.vocab = impl(*args, **params)

    def __getattr__(self, name):
        inner = self.__dict__.get("vocab")
        if inner is not None and hasattr(inner, name):
            return getattr(inner, name)
        raise AttributeError(f"Vocab has no attribute {name!r}")
