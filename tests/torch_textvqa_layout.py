"""A synthetic TextVQA data layout, in the real files' formats, from a
seed, and the fasttext stand-in its OCR tokens go through.

The CPU tests and ``chip_smoke.py`` write their TextVQA data with
``write_layout`` and point M4C's config at it with ``layout_opts``. Only
numpy and the port's native LMDB core (``utils/native/lmdb_shim``, which
imports neither torch nor JAX) are used, so the same module serves the
port, the JAX package and the card's machine.

Under ``root`` (the run's ``env.data_dir``):

- ``datasets/textvqa/defaults/annotations/imdb_{train,val,test}_ocr_en.npy``
  (MMF's imdb): a metadata row first, then one dict a question with
  ``question``, ``question_id``, ``image_id`` (a hex string),
  ``image_path`` (``<folder>/<id>.jpg``; the dataset reads the features
  at ``<folder>/<id>``, not at ``feature_path``, ``<id>.npy``),
  ``ocr_tokens``, ``ocr_normalized_boxes`` [n_ocr, 4],
  ``obj_normalized_boxes`` [n_obj, 4] and (not in test) ten
  ``answers``: words of the answer vocabulary, OCR tokens of the image
  (the copy targets) and their two-word joins, and words in neither;
- ``datasets/textvqa/defaults/features/open_images/detectron.lmdb``: the
  objects' fc6 features, and ``datasets/textvqa/ocr_en/features/
  ocr_en_frcn_features.lmdb``: the OCR boxes', both LMDB environments
  with ``b"keys"`` (the pickled key list) and one pickled dict a key
  (``image_id``, ``features`` [n, feature_dim] f32, ``bbox``,
  ``num_boxes``, ``image_height``, ``image_width``), written by the
  port's LMDB writer;
- ``VOCAB_FILE`` (``fixed_answer_vocab_textvqa_5k.txt``): ``num_answers``
  answers, ``<pad>``, ``<s>``, ``</s>``, ``<unk>`` first;
- ``vocab.txt``: the WordPiece vocabulary of ``tests/torch_vqa2_layout``
  (``vocab_size`` entries);
- the zoo's ``.built`` markers of ``textvqa.defaults``.

``FastTextStandIn`` stands for ``wiki.en.bin`` and the ``fasttext``
package, neither of which the repository carries: seeded 300-wide
vectors, the same for a word in every process.
"""

from __future__ import annotations

import os
import pickle
import zlib
from typing import Dict, List

import numpy as np

from tests.torch_vqa2_layout import _mark_built, _question, _vocab

ZOO_VERSION = "0.5.5_2020_06_30"  # configs/zoo/datasets.yaml textvqa
SPLITS = {"train": "imdb_train_ocr_en.npy", "val": "imdb_val_ocr_en.npy",
          "test": "imdb_test_ocr_en.npy"}
OBJ_LMDB = "textvqa/defaults/features/open_images/detectron.lmdb"
OCR_LMDB = "textvqa/ocr_en/features/ocr_en_frcn_features.lmdb"
VOCAB_FILE = ("textvqa/defaults/extras/vocabs/"
              "fixed_answer_vocab_textvqa_5k.txt")

_OCR_WORDS = ["stop", "exit", "sale", "open", "coca", "cola", "nike",
              "route", "66", "2014", "pepsi", "cafe", "hotel", "bus", "12",
              "main", "st", "apple", "yes", "no", "Sony", "LG", "Dell",
              "Intel", "CANON", "Ford's", "9:30", "$5", "a&w", "e-mail"]
_ANSWER_WORDS = ["yes", "no", "red", "blue", "two", "three", "stop",
                 "exit", "sale", "open", "coca", "cola", "nike", "route",
                 "66", "2014", "hotel", "main", "apple", "sony"]


def answer_words(num_answers: int) -> List[str]:
    words = ["<pad>", "<s>", "</s>", "<unk>"] + _ANSWER_WORDS
    words += [f"answer{i}" for i in range(num_answers - len(words))]
    return words[:num_answers]


class FastTextStandIn:
    """A fasttext model's two calls that the ``fasttext`` processor
    makes: 300-wide f32 vectors drawn from ``seed`` and the word's
    crc32, each drawn once (a real model looks a word up in
    microseconds; a generator a word takes ~0.1 ms)."""

    def __init__(self, seed: int = 0, dim: int = 300):
        self.seed, self.dim = seed, dim
        self._vectors = {}

    def get_dimension(self) -> int:
        return self.dim

    def get_word_vector(self, word: str) -> np.ndarray:
        if word not in self._vectors:
            key = (zlib.crc32(word.encode("utf-8")) + self.seed) % (2 ** 32)
            self._vectors[word] = np.random.RandomState(key).randn(
                self.dim).astype(np.float32)
        return self._vectors[word]


def _boxes(rng, n: int) -> np.ndarray:
    xy = rng.rand(n, 2) * 0.7
    wh = rng.rand(n, 2) * 0.3 + 0.01
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _write_lmdb(path: str, entries: Dict[str, dict]):
    from mmf_tpu_torch.utils.native import lmdb_shim

    env = lmdb_shim.open(path, subdir=True, readonly=False, create=True)
    keys = [k.encode() for k in entries]
    with env.begin(write=True) as txn:
        txn.put(b"keys", pickle.dumps(keys))
        for key, value in entries.items():
            txn.put(key.encode(), pickle.dumps(value))
    env.close()


def _answers(rng, ocr_tokens: List[str], vocab: List[str]) -> List[str]:
    lowered = [t.lower() for t in ocr_tokens]
    candidates = []
    for _ in range(3):
        kind = rng.rand()
        if lowered and kind < 0.4:
            candidates.append(lowered[rng.randint(len(lowered))])
        elif len(lowered) >= 2 and kind < 0.55:
            i = int(rng.randint(len(lowered) - 1))
            candidates.append(lowered[i] + " " + lowered[i + 1])
        elif kind < 0.9:
            candidates.append(vocab[4 + rng.randint(len(vocab) - 4)])
        else:
            candidates.append("nowhere to be found")
    return [candidates[int(i)] for i in rng.choice(3, size=10,
                                                   p=[0.6, 0.3, 0.1])]


def write_layout(root: str, n_train: int = 640, n_val: int = 128,
                 n_test: int = 64, n_images: int = 160, max_obj: int = 100,
                 max_ocr: int = 50, feature_dim: int = 2048,
                 num_answers: int = 5000, vocab_size: int = 30522,
                 seed: int = 0) -> Dict[str, str]:
    """Write the layout under ``root``; returns its main paths. An image
    has between ``max_obj // 2`` and ``max_obj`` objects and between 0
    and ``max_ocr`` OCR tokens (one image in eight has none)."""
    rng = np.random.RandomState(seed)
    datasets = os.path.join(root, "datasets")
    vocab = answer_words(num_answers)
    splits = {"train": n_train, "val": n_val, "test": n_test}
    n_test_images = max(1, n_images // 5)
    images = {"train": [f"{i:016x}" for i in
                        range(0x1a2b0000, 0x1a2b0000 + n_images
                              - n_test_images)],
              "test": [f"{i:016x}" for i in
                       range(0x5c6d0000, 0x5c6d0000 + n_test_images)]}

    obj, ocr, meta = {}, {}, {}
    for folder, ids in images.items():
        for i, image_id in enumerate(ids):
            key = f"{folder}/{image_id}"
            n_obj = int(rng.randint(max_obj // 2, max_obj + 1))
            n_ocr = 0 if i % 8 == 7 else int(rng.randint(1, max_ocr + 1))
            height, width = int(rng.randint(300, 1024)), int(
                rng.randint(300, 1024))
            tokens = [_OCR_WORDS[j] for j in
                      rng.randint(len(_OCR_WORDS), size=n_ocr)]
            obj_boxes, ocr_boxes = _boxes(rng, n_obj), _boxes(rng, n_ocr)
            for store, n, boxes in ((obj, n_obj, obj_boxes),
                                    (ocr, n_ocr, ocr_boxes)):
                store[key] = {
                    "image_id": key,
                    "features": rng.randn(n, feature_dim).astype(
                        np.float32),
                    "bbox": boxes * [width, height, width, height],
                    "num_boxes": n, "image_height": height,
                    "image_width": width,
                }
            meta[key] = (tokens, obj_boxes, ocr_boxes, height, width)
    _write_lmdb(os.path.join(datasets, OBJ_LMDB), obj)
    _write_lmdb(os.path.join(datasets, OCR_LMDB), ocr)

    annotations = os.path.join(datasets, "textvqa", "defaults",
                               "annotations")
    os.makedirs(annotations, exist_ok=True)
    question_id = 0
    for split, n in splits.items():
        folder = "test" if split == "test" else "train"
        ids = images[folder]
        rows = [{"creation_time": 0.0, "version": 0.5,
                 "dataset_type": split, "has_answer": split != "test"}]
        for i in range(n):
            image_id = ids[i % len(ids)]
            tokens, obj_boxes, ocr_boxes, height, width = meta[
                f"{folder}/{image_id}"]
            question = _question(rng)
            row = {"question": question, "question_id": question_id,
                   "image_id": image_id, "image_classes": ["Text"],
                   "image_width": width, "image_height": height,
                   "image_path": f"{folder}/{image_id}.jpg",
                   "feature_path": f"{image_id}.npy",
                   "set_name": split, "ocr_tokens": list(tokens),
                   "ocr_normalized_boxes": ocr_boxes,
                   "obj_normalized_boxes": obj_boxes}
            if split != "test":
                row["answers"] = _answers(rng, tokens, vocab)
            rows.append(row)
            question_id += 1
        np.save(os.path.join(annotations, SPLITS[split]),
                np.array(rows, dtype=object))

    vocab_path = os.path.join(datasets, VOCAB_FILE)
    os.makedirs(os.path.dirname(vocab_path), exist_ok=True)
    with open(vocab_path, "w") as f:
        f.write("\n".join(vocab) + "\n")
    vocab_file = os.path.join(root, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(_vocab(vocab_size)) + "\n")
    base = os.path.join(datasets, "textvqa")
    for sub in ("", "annotations", "features"):
        _mark_built(os.path.join(base, sub), ZOO_VERSION)
    return {"root": root, "vocab_file": vocab_file,
            "obj_lmdb": os.path.join(datasets, OBJ_LMDB),
            "ocr_lmdb": os.path.join(datasets, OCR_LMDB)}


def layout_opts(root: str) -> List[str]:
    """The dotlist that points TextVQA's config at the layout: the data
    dir and the WordPiece vocabulary (the feature and annotation paths
    are the config's own, with the OCR LMDB that
    ``flagship.TEXTVQA_M4C_OVERRIDES`` adds)."""
    return [f"env.data_dir={root}",
            "dataset_config.textvqa.processors.text_processor.params."
            "tokenizer_config.params.vocab_file="
            + os.path.join(root, "vocab.txt")]
