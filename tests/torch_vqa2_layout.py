"""A synthetic VQA2 data layout, in the real files' formats, from a seed.

Both the CPU tests and ``chip_smoke.py`` write their VQA2 data with
``write_layout`` and point the config at it with ``layout_opts``. Only
numpy is imported (neither torch nor JAX), so the same module serves
the port, the JAX package and the card's machine.

Under ``root`` (the run's ``env.data_dir``):

- ``datasets/vqa2/defaults/annotations/imdb_{train2014,val2014,
  test2015}.npy``: MMF's imdb, a metadata row first, then one dict a
  question with ``question`` (and the same as ``question_str``),
  ``question_id``, ``image_id``, ``image_name``, ``feature_path`` and
  (not in test) ten ``answers`` drawn from the answer vocabulary, some of
  them outside it (and the same as ``all_answers``, which the masked
  datasets read);
- ``datasets/coco/defaults/features/{trainval2014,test2015}/<image>.npy``:
  region features [regions, feature_dim] float32, each with its
  ``<image>_info.npy`` (``bbox``, ``num_boxes``, ``image_height``,
  ``image_width`` and, with ``cls_prob_width``, the detector's class
  probabilities ``cls_prob`` [num_boxes, cls_prob_width]); these stand
  for the config's LMDB files, which the port does not read yet. An
  image has between ``regions // 2`` and ``regions`` boxes, or exactly
  ``regions`` with ``full_boxes`` (as MMF's VQA2 features have: the side
  files' boxes then batch, which ViLBERT's box locations need);
- ``datasets/vqa2/defaults/extras/vocabs/answers_vqa.txt``:
  ``num_answers`` answers, ``<unk>`` first;
- ``vocab.txt``: a WordPiece vocabulary of ``vocab_size`` entries, BERT's
  special tokens at BERT's ids, the questions' words, ``##`` pieces and
  punctuation, and ``[unusedN]`` filler;
- the zoo's ``.built`` markers, so that the JAX package, which would
  download the zoo's resources otherwise, takes the layout as built.

``write_image_layout`` writes the raw-image form that
``projects/unit/configs/vqa2_dataset_cfg.yaml`` names (ViLT's VQA2
config): the ``split_by_coco_2017`` annotation files (five for train,
each paired with an image folder; ``imdb_val2017.npy``) and the test
split's ``imdb_test2015.npy``, over images in
``datasets/coco/defaults/images/{train2014,val2014,test2015}``. Each
image is PNG content (``png_bytes``) under ``<image_name>.jpg``, the
name the VQA2 dataset opens, so that PIL (JAX's loader, which goes by
content) and the port's PNG decoder read the same files; sizes are drawn
non-square, so that the processors resize. Its ``.built`` markers cannot
satisfy the JAX package's builder: ``vqa2.defaults`` and
``vqa2.split_by_coco_2017`` share ``datasets/vqa2/annotations`` with
different versions, so JAX's ``mmf_run`` would download one of them.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Sequence

import numpy as np

# configs/zoo/datasets.yaml: the versions of the zoo entries that
# configs/datasets/vqa2/defaults.yaml requires
ZOO_VERSIONS = {"coco": "1.0_2020_05_04", "vqa2": "1.0_2020_05_29"}
SPLITS = {"train": "imdb_train2014.npy", "val": "imdb_val2014.npy",
          "test": "imdb_test2015.npy"}
FEATURES = {"train": "trainval2014", "val": "trainval2014",
            "test": "test2015"}

_WORDS = ["what", "color", "is", "the", "man", "woman", "dog", "cat",
          "how", "many", "are", "there", "on", "table", "wear", "hold",
          "play", "sit", "red", "blue", "ball", "bus", "street", "people",
          "photo", "this", "in", "of", "a", "where", "which", "kind"]
_SUFFIXES = ["", "", "", "s", "ing", "ed", "zq"]  # "zq" is not a piece
_PIECES = ["##s", "##ing", "##ed", "##er"]
_PUNCTUATION = ["?", ",", "'", ".", "!"]
_SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
             103: "[MASK]"}


def _answer_words(num_answers: int) -> List[str]:
    base = ["yes", "no", "red", "blue", "two", "three", "dog", "cat",
            "table", "street", "ball", "man"]
    words = ["<unk>"] + base[:num_answers - 1]
    words += [f"answer{i}" for i in range(num_answers - len(words))]
    return words


def _vocab(vocab_size: int) -> List[str]:
    ordinary = _PUNCTUATION + _WORDS + _PIECES
    if vocab_size >= 104 + len(ordinary):
        # BERT's layout: [PAD] 0, [unused0-98] 1-99, [UNK] 100, [CLS] 101,
        # [SEP] 102, [MASK] 103, then the word pieces
        tokens = [_SPECIALS.get(i, f"[unused{i - 1}]") for i in range(104)]
    else:
        tokens = [_SPECIALS[i] for i in sorted(_SPECIALS)]
    tokens += ordinary
    n_unused = sum(t.startswith("[unused") for t in tokens)
    while len(tokens) < vocab_size:
        tokens.append(f"[unused{n_unused}]")
        n_unused += 1
    if len(tokens) != vocab_size:
        raise ValueError(f"vocab_size {vocab_size} is below the "
                         f"{len(tokens)} tokens the layout needs")
    return tokens


def _question(rng) -> str:
    n = int(rng.randint(3, 9))
    words = []
    for _ in range(n):
        word = _WORDS[rng.randint(len(_WORDS))]
        word += _SUFFIXES[rng.randint(len(_SUFFIXES))]
        if rng.rand() < 0.2:
            word = word.capitalize()
        words.append(word)
    if rng.rand() < 0.3:
        words.insert(int(rng.randint(1, n)), ",")
    return " ".join(words) + "?"


def _answers(rng, answer_words: List[str]) -> List[str]:
    # two or three candidates, so that the soft scores take several values
    candidates = list(rng.choice(answer_words[1:], size=3))
    if rng.rand() < 0.3:
        candidates[-1] = "not in the vocabulary"
    return [candidates[int(i)] for i in rng.choice(3, size=10,
                                                   p=[0.6, 0.3, 0.1])]


def _mark_built(path: str, version: str):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".built"), "w") as f:
        f.write("synthetic layout\n" + version)


def write_layout(root: str, n_train: int = 640, n_val: int = 128,
                 n_test: int = 64, n_images: int = 160, regions: int = 100,
                 feature_dim: int = 2048, num_answers: int = 3129,
                 vocab_size: int = 30522, seed: int = 0,
                 full_boxes: bool = False,
                 cls_prob_width: int = 0,
                 glove: bool = False) -> Dict[str, str]:
    """Write the layout under ``root``; returns its main paths. The
    class probabilities come from a second generator, so the other
    fields are the same with and without them. ``glove`` also writes
    what VQA2's ``vocab`` text processor reads: ``vocabulary_100k.txt``
    (every word a question can hold) and 300-wide random vectors in
    ``datasets/vectors/glove.6B.300d.txt``."""
    rng = np.random.RandomState(seed)
    cls_rng = np.random.RandomState(seed + 1)
    datasets = os.path.join(root, "datasets")
    vqa2 = os.path.join(datasets, "vqa2", "defaults")
    coco = os.path.join(datasets, "coco", "defaults")
    answer_words = _answer_words(num_answers)

    n_test_images = max(1, n_images // 5)
    images = {"trainval2014": [f"COCO_trainval2014_{i:012d}"
                               for i in range(n_images - n_test_images)],
              "test2015": [f"COCO_test2015_{i:012d}"
                           for i in range(n_test_images)]}
    for folder, names in images.items():
        out = os.path.join(coco, "features", folder)
        os.makedirs(out, exist_ok=True)
        for name in names:
            n_boxes = int(rng.randint(regions // 2, regions + 1))
            if full_boxes:
                n_boxes = regions
            feats = rng.randn(n_boxes, feature_dim).astype(np.float32)
            np.save(os.path.join(out, name + ".npy"), feats)
            height, width = int(rng.randint(200, 640)), int(
                rng.randint(200, 640))
            xy = rng.rand(n_boxes, 2) * [width / 2, height / 2]
            wh = rng.rand(n_boxes, 2) * [width / 2, height / 2] + 1
            info = {"bbox": np.concatenate([xy, xy + wh], 1).astype(
                        np.float32),
                    "num_boxes": n_boxes, "image_height": height,
                    "image_width": width}
            if cls_prob_width:
                logits = 3.0 * cls_rng.randn(n_boxes, cls_prob_width)
                probs = np.exp(logits - logits.max(1, keepdims=True))
                info["cls_prob"] = (probs / probs.sum(1, keepdims=True)
                                    ).astype(np.float32)
            np.save(os.path.join(out, name + "_info.npy"), info)

    os.makedirs(os.path.join(vqa2, "annotations"), exist_ok=True)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    question_id = 0
    for split, n in counts.items():
        names = images[FEATURES[split]]
        rows = [{"creation_time": 0.0, "version": 1.0,
                 "dataset_type": split, "has_answer": split != "test"}]
        for i in range(n):
            name = names[i % len(names)]
            question = _question(rng)
            row = {"question": question, "question_str": question,
                   "question_id": question_id,
                   "image_id": int(name.rsplit("_", 1)[1]),
                   "image_name": name,
                   "feature_path": name + ".npy"}
            if split != "test":
                row["answers"] = _answers(rng, answer_words)
                row["all_answers"] = list(row["answers"])
            rows.append(row)
            question_id += 1
        np.save(os.path.join(vqa2, "annotations", SPLITS[split]),
                np.array(rows, dtype=object))

    vocab_dir = os.path.join(vqa2, "extras", "vocabs")
    os.makedirs(vocab_dir, exist_ok=True)
    with open(os.path.join(vocab_dir, "answers_vqa.txt"), "w") as f:
        f.write("\n".join(answer_words) + "\n")
    vocab_file = os.path.join(root, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(_vocab(vocab_size)) + "\n")
    if glove:
        words = sorted({w + s for w in _WORDS for s in _SUFFIXES})
        with open(os.path.join(vocab_dir, "vocabulary_100k.txt"), "w") as f:
            f.write("\n".join(words) + "\n")
        os.makedirs(os.path.join(datasets, "vectors"), exist_ok=True)
        vec_rng = np.random.RandomState(seed + 2)
        with open(os.path.join(datasets, "vectors", "glove.6B.300d.txt"),
                  "w") as f:
            for w in words:
                f.write(w + " " + " ".join(
                    f"{x:.4f}" for x in vec_rng.randn(300)) + "\n")

    for name, version in ZOO_VERSIONS.items():
        base = os.path.join(datasets, name)
        for sub in ("", "annotations", "features"):
            _mark_built(os.path.join(base, sub), version)
    return {"root": root, "vocab_file": vocab_file}


def layout_opts(root: str, dataset: str = "vqa2",
                text_processor: str = "text_processor") -> List[str]:
    """The dotlist that points ``dataset``'s config (VQA2's, or one of
    its variants') at the layout; ``text_processor`` names the processor
    that reads the WordPiece vocabulary (``masked_token_processor`` for
    ``masked_vqa2``)."""
    opts = [f"env.data_dir={root}"]
    for split, folder in FEATURES.items():
        opts.append(f"dataset_config.{dataset}.features.{split}="
                    f"[coco/defaults/features/{folder}]")
    opts.append(f"dataset_config.{dataset}.processors.{text_processor}."
                "params.tokenizer_config.params.vocab_file="
                + os.path.join(root, "vocab.txt"))
    return opts


# the raw-image VQA2 layout (projects/unit/configs/vqa2_dataset_cfg.yaml)
SPLIT_2017 = "vqa2/split_by_coco_2017/annotations"
IMAGE_SPLITS = {  # split -> [(annotation file, image folder)]
    "train": [(f"{SPLIT_2017}/imdb_train2017_in_train2014.npy",
               "train2014"),
              (f"{SPLIT_2017}/imdb_train2017_in_val2014.npy", "val2014"),
              (f"{SPLIT_2017}/imdb_vg_karpathytrain_in_train2014.npy",
               "train2014"),
              (f"{SPLIT_2017}/imdb_vg_karpathytrain_in_val2014_not_in_"
               "val2017.npy", "val2014"),
              (f"{SPLIT_2017}/imdb_vg_karpathytest_not_in_val2017.npy",
               "val2014")],
    "val": [(f"{SPLIT_2017}/imdb_val2017.npy", "val2014")],
    "test": [("vqa2/defaults/annotations/imdb_test2015.npy", "test2015")],
}
SPLIT_2017_VERSION = "1.0_2021_02_05"  # configs/zoo/datasets.yaml


def _paeth(a, b, c):
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def png_bytes(pixels: np.ndarray, filters: Sequence[int] = (0, 1, 2),
              palette: np.ndarray = None) -> bytes:
    """8-bit non-interlaced PNG of ``pixels`` ([H, W] grey, [H, W, 2]
    grey + alpha, [H, W, 3] RGB, [H, W, 4] RGBA; or, with ``palette``
    [N, 3], [H, W] indices), row y filtered with ``filters[y %
    len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    pixels = np.asarray(pixels, np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, c = pixels.shape
    colour = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = pixels.reshape(h, w * c)
    out = bytearray()
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        kind = filters[y % len(filters)]
        x = rows[y]
        left = np.concatenate([np.zeros(c, np.uint8), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.uint8), prev[:-c]])
        pred = {0: np.zeros_like(x), 1: left, 2: prev,
                3: ((left.astype(np.uint16) + prev) // 2).astype(np.uint8),
                4: _paeth(left, prev, upleft)}[kind]
        out.append(kind)
        out += (x - pred).astype(np.uint8).tobytes()
        prev = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    body = chunk(b"IHDR", header)
    if palette is not None:
        body += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + body
            + chunk(b"IDAT", zlib.compress(bytes(out), 6))
            + chunk(b"IEND", b""))


def _image(rng, min_side: int, max_side: int) -> np.ndarray:
    """[H, W, 3] uint8, H != W: a colour gradient with noise, so that it
    compresses as a photo might."""
    h = int(rng.randint(min_side, max_side + 1))
    w = int(rng.randint(min_side, max_side + 1))
    if w == h:
        w = h + 1 if h < max_side else h - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.rand(3) * 255
    slope = (rng.rand(3, 2) - 0.5) * 2
    img = (base[:, None, None] + slope[:, 0, None, None] * yy
           + slope[:, 1, None, None] * xx)
    img = img.transpose(1, 2, 0) + rng.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def write_image_layout(root: str, n_train: int = 640, n_val: int = 128,
                       n_test: int = 64, n_images: int = 160,
                       min_side: int = 200, max_side: int = 480,
                       num_answers: int = 3129, vocab_size: int = 30522,
                       seed: int = 0) -> Dict[str, str]:
    """Write the raw-image layout under ``root``; returns its main paths.
    ``n_train`` questions are spread over the five train files."""
    rng = np.random.RandomState(seed)
    datasets = os.path.join(root, "datasets")
    answer_words = _answer_words(num_answers)
    n_test_images = max(1, n_images // 5)
    n_each = max(1, (n_images - n_test_images) // 2)
    counts = {"train2014": n_each, "val2014": n_each,
              "test2015": n_test_images}
    images = {}
    for folder, n in counts.items():
        out = os.path.join(datasets, "coco", "defaults", "images", folder)
        os.makedirs(out, exist_ok=True)
        images[folder] = [f"COCO_{folder}_{i:012d}" for i in range(n)]
        for name in images[folder]:
            with open(os.path.join(out, name + ".jpg"), "wb") as f:
                f.write(png_bytes(_image(rng, min_side, max_side)))

    question_id = 0
    totals = {"train": n_train, "val": n_val, "test": n_test}
    for split, files in IMAGE_SPLITS.items():
        shares = np.full(len(files), totals[split] // len(files))
        shares[:totals[split] % len(files)] += 1
        for (path, folder), n in zip(files, shares):
            names = images[folder]
            rows = [{"creation_time": 0.0, "version": 1.0,
                     "dataset_type": split, "has_answer": split != "test"}]
            for i in range(int(n)):
                name = names[int(rng.randint(len(names)))]
                question = _question(rng)
                row = {"question": question, "question_str": question,
                       "question_id": question_id,
                       "image_id": int(name.rsplit("_", 1)[1]),
                       "image_name": name}
                if split != "test":
                    row["answers"] = _answers(rng, answer_words)
                    row["all_answers"] = list(row["answers"])
                rows.append(row)
                question_id += 1
            full = os.path.join(datasets, path)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            np.save(full, np.array(rows, dtype=object))

    vocab_dir = os.path.join(datasets, "vqa2", "defaults", "extras",
                             "vocabs")
    os.makedirs(vocab_dir, exist_ok=True)
    with open(os.path.join(vocab_dir, "answers_vqa.txt"), "w") as f:
        f.write("\n".join(answer_words) + "\n")
    vocab_file = os.path.join(root, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(_vocab(vocab_size)) + "\n")
    for name, version in ZOO_VERSIONS.items():
        for sub in ("", "annotations", "images"):
            _mark_built(os.path.join(datasets, name, sub), version)
    return {"root": root, "vocab_file": vocab_file}


def image_layout_opts(root: str, dataset: str = "vqa2") -> List[str]:
    """The dotlist that points a raw-image VQA2 config at the layout."""
    return [f"env.data_dir={root}",
            f"dataset_config.{dataset}.processors.text_processor.params."
            "tokenizer_config.params.vocab_file="
            + os.path.join(root, "vocab.txt")]
