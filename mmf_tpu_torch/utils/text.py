"""Text utilities: tokenization and vocabulary dictionaries.

Port of the parts of ``mmf_tpu/utils/text.py`` that the VQA2 processors
call: ``tokenize``, ``word_tokenize``, ``load_str_list`` and
``VocabDict``. The caption decoders wait for the models that use them.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

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
