"""Synthetic TextVQA, ST-VQA, OCR-VQA and TextCaps data layouts, in
the real files' formats, from a seed, and the fasttext stand-in their
OCR tokens go through.

The CPU tests and ``chip_smoke.py`` write their M4C data with
``write_layout(root, dataset=...)`` and point the dataset's config at it
with ``layout_opts(root, dataset)``. Only numpy and the port's native
LMDB core (``utils/native/lmdb_shim``, which imports neither torch nor
JAX) are used, so the same module serves the port, the JAX package and
the card's machine.

Under ``root`` (the run's ``env.data_dir``), for TextVQA:

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
- ``textvqa/defaults/extras/vocabs/fixed_answer_vocab_textvqa_5k.txt``:
  ``num_answers`` answers, ``<pad>``, ``<s>``, ``</s>``, ``<unk>`` first
  (the other datasets' vocabularies hold the same answers in another
  order);
- ``vocab.txt``: the WordPiece vocabulary of ``tests/torch_vqa2_layout``
  (``vocab_size`` entries);
- the zoo's ``.built`` markers of ``textvqa.defaults``.

The other datasets write the same files under ``datasets/<dataset>/``
(``DATASETS`` names each one's paths and zoo version), with their own
annotation rows:

- ST-VQA: ``image_path`` and ``feature_path`` name an image of a source
  collection (``coco-text/COCO_train2014_<n>.jpg``, ``icdar/...``, ...);
  the dataset reads the features at ``feature_path`` under the split's
  folder (``train/`` or, for test, ``test_task3/``), so the LMDB keys are
  ``train/<source>/<name>`` and ``test_task3/<source>/<name>``. The ten
  ``answers`` repeat one or two distinct answers (ST-VQA has one or two
  a question), some with characters beyond ASCII (``café``, ``straße``,
  which the OCR tokens also hold).
- OCR-VQA: book covers named by their ten-digit ASIN
  (``<folder>/<asin>.jpg``); the ten ``answers`` repeat one answer (an
  OCR token, two joined, a vocabulary word or words in neither).
- TextCaps: no ``question`` and no ``answers``; each row has a
  ``caption_id``; train and val rows a ``caption_str`` (one of the
  image's five captions) and ``reference_strs`` (all five), test rows
  neither. Captions are lowercase sentences of vocabulary words, OCR
  tokens of the image (copies), and, in about half of them, words in
  neither (``zebra``, ``lighthouse``, ...); half end in a period. The
  ``m4c_answer`` processor cannot spell a caption with such a word, nor
  one whose last token keeps its period (``simple_word`` strips only
  commas and question marks), and gives it no loss.

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


def _paths(dataset: str, version: str) -> dict:
    return {"version": version,
            "obj_lmdb": f"{dataset}/defaults/features/open_images/"
                        "detectron.lmdb",
            "ocr_lmdb": f"{dataset}/ocr_en/features/ocr_en_frcn_features.lmdb",
            "vocab_file": f"{dataset}/defaults/extras/vocabs/"
                          f"fixed_answer_vocab_{dataset}_5k.txt"}


# each dataset's files under datasets/ and its zoo version
# (configs/zoo/datasets.yaml; the LMDBs and the vocabulary are the paths
# of configs/datasets/<dataset>/defaults.yaml and of the OCR features'
# override in utils/flagship.py)
DATASETS = {"textvqa": _paths("textvqa", ZOO_VERSION),
            "stvqa": _paths("stvqa", "1.0_2020_04_28"),
            "ocrvqa": _paths("ocrvqa", "1.0_2020_04_28"),
            "textcaps": _paths("textcaps", "1.0_2020_05_04"),
            # the COCO captions of configs/datasets/coco/ocr_en.yaml and of
            # the joint TextCaps + COCO config, with their joint vocabulary
            "coco_m4c": {
                "version": "1.0_2020_05_04",
                "obj_lmdb": "coco/m4c_captioner/features/detectron.lmdb",
                "ocr_lmdb": "coco/ocr_en/features/ocr_en_frcn_features.lmdb",
                "vocab_file": "coco/m4c_captioner/extras/vocabs/"
                              "vocab_joint_textcaps_coco_threshold_10.txt",
                "annotations": "coco/m4c_captioner/annotations",
                "splits": {"train": "imdb_karpathy_train.npy",
                           "val": "imdb_karpathy_val_filtered_by_image_id"
                                  ".npy",
                           "test": "imdb_karpathy_test_filtered_by_image_id"
                                   ".npy"}}}
CAPTIONS = ("textcaps", "coco_m4c")
_STVQA_SOURCES = ["coco-text", "icdar", "imageNet", "vizwiz", "textVQA"]
_NON_ASCII = ["café", "straße", "niño", "résumé"]
_CAPTION_OOV = ["zebra", "lighthouse", "umbrella", "saxophone", "giraffe"]

_OCR_WORDS = ["stop", "exit", "sale", "open", "coca", "cola", "nike",
              "route", "66", "2014", "pepsi", "cafe", "hotel", "bus", "12",
              "main", "st", "apple", "yes", "no", "Sony", "LG", "Dell",
              "Intel", "CANON", "Ford's", "9:30", "$5", "a&w", "e-mail"]
_ANSWER_WORDS = ["yes", "no", "red", "blue", "two", "three", "stop",
                 "exit", "sale", "open", "coca", "cola", "nike", "route",
                 "66", "2014", "hotel", "main", "apple", "sony"]


def answer_words(num_answers: int, dataset: str = "textvqa") -> List[str]:
    """The answer vocabulary: ``<pad>``, ``<s>``, ``</s>``, ``<unk>``, then
    answers; each dataset other than TextVQA holds the same answers in an
    order of its own (the real vocabularies differ)."""
    words = _ANSWER_WORDS + [f"answer{i}" for i in
                             range(max(0, num_answers - 4
                                       - len(_ANSWER_WORDS)))]
    words = words[:max(0, num_answers - 4)]
    if dataset != "textvqa":
        order = np.random.RandomState(zlib.crc32(dataset.encode()))
        words = [words[i] for i in order.permutation(len(words))]
    return (["<pad>", "<s>", "</s>", "<unk>"] + words)[:num_answers]


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


def _image_ids(dataset: str, n_images: int) -> Dict[str, List[str]]:
    """Image names of the train (train and val questions) and test
    folders."""
    n_test = max(1, n_images // 5)
    counts = {"train": n_images - n_test, "test": n_test}
    if dataset == "stvqa":
        return {folder: [
            f"{_STVQA_SOURCES[i % len(_STVQA_SOURCES)]}/"
            f"COCO_{folder}2014_{i + (0 if folder == 'train' else 50000):012d}"
            for i in range(n)] for folder, n in counts.items()}
    if dataset == "ocrvqa":  # book covers by their ten-digit ASINs
        bases = {"train": 1400000000, "test": 1600000000}
        return {folder: [f"{bases[folder] + i:010d}" for i in range(n)]
                for folder, n in counts.items()}
    return {"train": [f"{i:016x}" for i in
                      range(0x1a2b0000, 0x1a2b0000 + counts["train"])],
            "test": [f"{i:016x}" for i in
                     range(0x5c6d0000, 0x5c6d0000 + counts["test"])]}


def _caption(rng, tokens: List[str], vocab: List[str]) -> str:
    words = ["a"] if "a" in vocab else []
    for _ in range(int(rng.randint(3, 10))):
        kind = rng.rand()
        if tokens and kind < 0.35:
            words.append(tokens[rng.randint(len(tokens))].lower())
        else:
            words.append(vocab[4 + rng.randint(len(vocab) - 4)])
    if rng.rand() < 0.5:
        words.insert(int(rng.randint(len(words) + 1)),
                     _CAPTION_OOV[rng.randint(len(_CAPTION_OOV))])
    return " ".join(words) + ("." if rng.rand() < 0.5 else "")


def _row(rng, dataset: str, split: str, folder: str, image_id: str,
         index: int, meta, vocab: List[str]) -> dict:
    """One annotation row of ``dataset``."""
    tokens, obj_boxes, ocr_boxes, height, width = meta
    row = {"image_id": image_id, "image_classes": ["Text"],
           "image_width": width, "image_height": height,
           "image_path": f"{folder}/{image_id}.jpg",
           "feature_path": f"{image_id}.npy",
           "set_name": split, "ocr_tokens": list(tokens),
           "ocr_normalized_boxes": ocr_boxes,
           "obj_normalized_boxes": obj_boxes}
    if dataset == "stvqa":
        row["image_path"] = f"{image_id}.jpg"
    if dataset in CAPTIONS:
        row["caption_id"] = index
        if split != "test":
            refs = [_caption(rng, tokens, vocab) for _ in range(5)]
            row["caption_str"] = refs[index % 5]
            row["reference_strs"] = refs
            if dataset == "coco_m4c":  # COCO's imdb also holds the tokens
                row["caption_tokens"] = refs[index % 5].split()
                row["reference_tokens"] = [r.split() for r in refs]
        return row
    row["question"] = _question(rng)
    row["question_id"] = index
    if split == "test":
        return row
    if dataset == "textvqa":
        row["answers"] = _answers(rng, tokens, vocab)
    else:
        distinct = _answers(rng, tokens, vocab)[:2 if dataset == "stvqa"
                                                 else 1]
        if dataset == "stvqa" and rng.rand() < 0.15:
            distinct[0] = _NON_ASCII[rng.randint(len(_NON_ASCII))]
        row["answers"] = [distinct[i % len(distinct)] for i in range(10)]
    return row


def write_layout(root: str, n_train: int = 640, n_val: int = 128,
                 n_test: int = 64, n_images: int = 160, max_obj: int = 100,
                 max_ocr: int = 50, feature_dim: int = 2048,
                 num_answers: int = 5000, vocab_size: int = 30522,
                 seed: int = 0, dataset: str = "textvqa") -> Dict[str, str]:
    """Write ``dataset``'s layout under ``root``; returns its main paths.
    An image has between ``max_obj // 2`` and ``max_obj`` objects and
    between 0 and ``max_ocr`` OCR tokens (one image in eight has none).
    Several datasets may share one ``root`` (the joint config reads
    TextVQA's and ST-VQA's)."""
    rng = np.random.RandomState(seed)
    datasets = os.path.join(root, "datasets")
    files = DATASETS[dataset]
    vocab = answer_words(num_answers, dataset)
    splits = {"train": n_train, "val": n_val, "test": n_test}
    images = _image_ids(dataset, n_images)
    ocr_words = _OCR_WORDS + (_NON_ASCII if dataset == "stvqa" else [])

    obj, ocr, meta = {}, {}, {}
    for folder, ids in images.items():
        for i, image_id in enumerate(ids):
            key = f"{folder}/{image_id}"
            if dataset == "stvqa" and folder == "test":
                key = f"test_task3/{image_id}"
            n_obj = int(rng.randint(max_obj // 2, max_obj + 1))
            n_ocr = 0 if i % 8 == 7 else int(rng.randint(1, max_ocr + 1))
            height, width = int(rng.randint(300, 1024)), int(
                rng.randint(300, 1024))
            tokens = [ocr_words[j] for j in
                      rng.randint(len(ocr_words), size=n_ocr)]
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
            meta[f"{folder}/{image_id}"] = (tokens, obj_boxes, ocr_boxes,
                                           height, width)
    _write_lmdb(os.path.join(datasets, files["obj_lmdb"]), obj)
    _write_lmdb(os.path.join(datasets, files["ocr_lmdb"]), ocr)

    annotations = os.path.join(datasets, files.get(
        "annotations", f"{dataset}/defaults/annotations"))
    os.makedirs(annotations, exist_ok=True)
    index = 0
    for split, n in splits.items():
        folder = "test" if split == "test" else "train"
        ids = images[folder]
        rows = [{"creation_time": 0.0, "version": 0.5,
                 "dataset_type": split, "has_answer": split != "test"}]
        for i in range(n):
            image_id = ids[i % len(ids)]
            rows.append(_row(rng, dataset, split, folder, image_id, index,
                             meta[f"{folder}/{image_id}"], vocab))
            index += 1
        np.save(os.path.join(annotations,
                             files.get("splits", SPLITS)[split]),
                np.array(rows, dtype=object))

    vocab_path = os.path.join(datasets, files["vocab_file"])
    os.makedirs(os.path.dirname(vocab_path), exist_ok=True)
    with open(vocab_path, "w") as f:
        f.write("\n".join(vocab) + "\n")
    vocab_file = os.path.join(root, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(_vocab(vocab_size)) + "\n")
    base = os.path.join(datasets, files["obj_lmdb"].split("/")[0])
    for sub in ("", "annotations", "features"):
        _mark_built(os.path.join(base, sub), files["version"])
    return {"root": root, "vocab_file": vocab_file,
            "obj_lmdb": os.path.join(datasets, files["obj_lmdb"]),
            "ocr_lmdb": os.path.join(datasets, files["ocr_lmdb"])}


def layout_opts(root: str, dataset: str = "textvqa") -> List[str]:
    """The dotlist that points ``dataset``'s config at the layout: the
    data dir and the WordPiece vocabulary (the feature and annotation
    paths are the config's own, with the OCR LMDB that the dataset's
    ``flagship`` overrides add)."""
    return [f"env.data_dir={root}",
            f"dataset_config.{dataset}.processors.text_processor.params."
            "tokenizer_config.params.vocab_file="
            + os.path.join(root, "vocab.txt")]


def write_joint_coco_layout(root: str, n_train: int = 64, n_val: int = 16,
                            n_test: int = 16, n_images: int = 40,
                            coco_images: int = 40, **kwargs) -> Dict[str, str]:
    """The files of ``projects/m4c_captioner/configs/m4c_captioner/
    textcaps/joint_with_coco.yaml`` under ``root``: TextCaps' layout
    (``write_layout(dataset="textcaps")``), its train annotations also as
    ``imdb_train.npy`` and its LMDBs also under TextVQA's paths (the
    config reads TextCaps' images there, as MMF's TextCaps shares
    TextVQA's Open Images features), and COCO's captions in TextCaps'
    row format (``dataset="coco_m4c"``: their own images, LMDBs and
    annotations, and the joint vocabulary, which is what the config's
    answer processor reads; it holds the same answers as TextCaps' in
    another order). ``kwargs`` go to both ``write_layout`` calls."""
    import shutil

    paths = write_layout(root, n_train, n_val, n_test, n_images,
                         dataset="textcaps", **kwargs)
    write_layout(root, n_train, n_val, n_test, coco_images,
                 dataset="coco_m4c", **dict(kwargs, seed=kwargs.get(
                     "seed", 0) + 1))
    datasets = os.path.join(root, "datasets")
    annotations = os.path.join(datasets, "textcaps", "defaults",
                               "annotations")
    shutil.copy(os.path.join(annotations, SPLITS["train"]),
                os.path.join(annotations, "imdb_train.npy"))
    for key in ("obj_lmdb", "ocr_lmdb"):
        target = os.path.join(datasets, DATASETS["textvqa"][key])
        if os.path.exists(target):
            shutil.rmtree(target)
        shutil.copytree(os.path.join(datasets, DATASETS["textcaps"][key]),
                        target)
    for sub in ("", "annotations", "features"):
        _mark_built(os.path.join(datasets, "textvqa", sub), ZOO_VERSION)
    return paths
