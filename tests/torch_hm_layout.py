"""A synthetic Hateful Memes data layout, in the real files' formats,
from a seed.

Both the CPU tests and ``chip_smoke.py`` write their Hateful Memes data
with ``write_layout`` and point a config at it with ``layout_opts``.
Only numpy is imported (neither torch nor JAX), so the same module
serves the port, the JAX package and the card's machine.

Under ``root`` (the run's ``env.data_dir``), in
``datasets/hateful_memes/defaults/``:

- ``images/img/NNNNN.png``: ``n_images`` memes, PNG of 300-800 px a
  side (mixed, never square), every fifth grey and every seventh
  palette-coloured, the rest RGB; several samples may share one image;
- ``annotations/{train,dev_unseen,test_unseen}.jsonl``: one JSON object
  a line with ``id``, ``img`` (``img/NNNNN.png``), ``text`` (a caption
  of 3-12 words) and ``label`` (0 or 1, about a third hateful); with
  ``fine_grained``, also ``top_attacks`` and ``top_protectedcats``;
- with ``features``, ``features/NNNNN.npy`` region features
  [``regions``, ``feature_dim``] float32 with their ``_info.npy``
  (``bbox``, ``num_boxes``, ``image_height``, ``image_width``): what the
  features dataset reads where the real config names ``detectron.lmdb``;
- ``extras/vocabs/vocabulary_100k.txt``: every word a caption can hold,
  with 300-wide random vectors in ``datasets/vectors/glove.6B.300d.txt``
  (``concat_bow``'s and ``unimodal_text``'s ``intersected`` vocab);
- ``vocab.txt`` at ``root``: a WordPiece vocabulary of ``vocab_size``
  entries (``tests/torch_vqa2_layout.py``'s);
- the zoo's ``.built`` markers, so that the JAX package, which would
  download the zoo's resources otherwise, takes the layout as built.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from tests.torch_vqa2_layout import (
    _SUFFIXES,
    _WORDS,
    _image,
    _mark_built,
    _vocab,
    png_bytes,
)

# configs/zoo/datasets.yaml: hateful_memes.defaults
ZOO_VERSION = "1.0_2020_10_01"
BASE = "hateful_memes/defaults"
SPLITS = {"train": "train.jsonl", "val": "dev_unseen.jsonl",
          "test": "test_unseen.jsonl"}
ATTACKS = ["contempt", "dehumanizing", "exclusion", "inciting_violence",
           "inferiority", "mocking", "slurs"]
GROUPS = ["disability", "nationality", "race", "religion", "sex"]


def _caption(rng) -> str:
    n = int(rng.randint(3, 13))
    words = []
    for _ in range(n):
        word = _WORDS[rng.randint(len(_WORDS))]
        word += _SUFFIXES[rng.randint(len(_SUFFIXES))]
        if rng.rand() < 0.2:
            word = word.capitalize()
        words.append(word)
    return " ".join(words)


def _meme(rng, index: int) -> bytes:
    pixels = _image(rng, 300, 800)
    if index % 5 == 1:
        return png_bytes(pixels.mean(axis=2).astype(np.uint8))
    if index % 7 == 2:
        palette = rng.randint(0, 256, (16, 3)).astype(np.uint8)
        return png_bytes((pixels[..., 0] // 16).astype(np.uint8),
                         palette=palette)
    return png_bytes(pixels)


def write_layout(root: str, n_train: int = 256, n_val: int = 64,
                 n_test: int = 64, n_images: int = 96,
                 vocab_size: int = 30522, seed: int = 0,
                 features: bool = False, regions: int = 100,
                 feature_dim: int = 2048,
                 fine_grained: bool = False) -> Dict[str, str]:
    """Write the layout under ``root``; returns its main paths."""
    rng = np.random.RandomState(seed)
    datasets = os.path.join(root, "datasets")
    base = os.path.join(datasets, BASE)
    image_dir = os.path.join(base, "images", "img")
    os.makedirs(image_dir, exist_ok=True)
    stems = [f"{10000 + 37 * i:05d}" for i in range(n_images)]
    for i, stem in enumerate(stems):
        with open(os.path.join(image_dir, stem + ".png"), "wb") as f:
            f.write(_meme(rng, i))
    if features:
        feature_rng = np.random.RandomState(seed + 1)
        out = os.path.join(base, "features")
        os.makedirs(out, exist_ok=True)
        for stem in stems:
            np.save(os.path.join(out, stem + ".npy"), feature_rng.randn(
                regions, feature_dim).astype(np.float32))
            h, w = (int(x) for x in feature_rng.randint(300, 800, 2))
            xy = feature_rng.rand(regions, 2) * [w / 2, h / 2]
            wh = feature_rng.rand(regions, 2) * [w / 2, h / 2] + 1
            np.save(os.path.join(out, stem + "_info.npy"), {
                "bbox": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                "num_boxes": regions, "image_height": h, "image_width": w})

    os.makedirs(os.path.join(base, "annotations"), exist_ok=True)
    next_id = 1
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        rows: List[str] = []
        for _ in range(n):
            stem = stems[int(rng.randint(n_images))]
            row = {"id": next_id, "img": f"img/{stem}.png",
                   "label": int(rng.rand() < 0.35), "text": _caption(rng)}
            if fine_grained:
                hateful = row["label"] == 1
                row["top_attacks"] = (list(rng.choice(ATTACKS, 1 + int(
                    rng.rand() < 0.3), replace=False)) if hateful
                    else ["attack_empty"])
                row["top_protectedcats"] = (list(rng.choice(GROUPS, 1 + int(
                    rng.rand() < 0.3), replace=False)) if hateful
                    else ["pc_empty"])
            rows.append(json.dumps(row))
            next_id += 1
        with open(os.path.join(base, "annotations", SPLITS[split]),
                  "w") as f:
            f.write("\n".join(rows) + "\n")

    words = sorted({w + s for w in _WORDS for s in _SUFFIXES})
    vocab_dir = os.path.join(base, "extras", "vocabs")
    os.makedirs(vocab_dir, exist_ok=True)
    with open(os.path.join(vocab_dir, "vocabulary_100k.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    os.makedirs(os.path.join(datasets, "vectors"), exist_ok=True)
    vec_rng = np.random.RandomState(seed + 2)
    with open(os.path.join(datasets, "vectors", "glove.6B.300d.txt"),
              "w") as f:
        for w in words:
            f.write(w + " " + " ".join(
                f"{x:.4f}" for x in vec_rng.randn(300)) + "\n")
    vocab_file = os.path.join(root, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(_vocab(vocab_size)) + "\n")
    hm = os.path.join(datasets, "hateful_memes")
    for sub in ("", "features", "images", "annotations"):
        _mark_built(os.path.join(hm, sub), ZOO_VERSION)
    return {"root": root, "vocab_file": vocab_file}


def layout_opts(root: str, bert: bool = True) -> List[str]:
    """The dotlist that points a Hateful Memes config at the layout;
    ``bert`` when its text processor is ``bert_tokenizer`` (the
    ``bert.yaml`` dataset config), which reads the WordPiece vocab."""
    opts = [f"env.data_dir={root}"]
    if bert:
        opts.append("dataset_config.hateful_memes.processors."
                    "text_processor.params.tokenizer_config.params."
                    "vocab_file=" + os.path.join(root, "vocab.txt"))
    return opts
