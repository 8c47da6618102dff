"""Annotation database: npy, jsonl and json imdb files.

Port of ``mmf_tpu/datasets/databases/annotation_database.py`` (the
visual-dialog reader waits for its dataset): MMF's npy imdb with its
metadata row first (``start_idx`` 1), jsonl rows, and json files with
``metadata`` and ``data``; the legacy imdb answer fields normalised to
``answers``.
"""

from __future__ import annotations

import json

import numpy as np

from mmf_tpu_torch.utils.general import get_absolute_path


class AnnotationDatabase:
    def __init__(self, config, path, *args, **kwargs):
        self.metadata = {}
        self.config = config
        self.start_idx = 0
        path = get_absolute_path(path)
        self.load_annotation_db(path)

    def load_annotation_db(self, path: str):
        if path.endswith(".npy"):
            self._load_npy(path)
        elif path.endswith(".jsonl"):
            self._load_jsonl(path)
        elif path.endswith(".json"):
            self._load_json(path)
        else:
            raise ValueError("Unknown file format for annotation db")

    def _load_jsonl(self, path):
        with open(path, "r") as f:
            db = f.readlines()
        self.data = [json.loads(line.strip("\n")) for line in db]
        self.start_idx = 0

    def _load_npy(self, path):
        with open(path, "rb") as f:
            self.db = np.load(f, allow_pickle=True)
        self.start_idx = 0
        if isinstance(self.db, dict):
            self.metadata = self.db.get("metadata", {})
            self.data = self.db.get("data", [])
        else:
            self.metadata = {"version": 1}
            self.data = self.db
            # old imdbs carry a header row
            if "image_id" not in self.data[0]:
                self.start_idx = 1
        if len(self.data) == 0:
            self.data = self.db

    def _load_json(self, path):
        with open(path, "r") as f:
            data = json.load(f)
        self.metadata = data.get("metadata", {})
        self.data = data.get("data", [])
        if len(self.data) == 0:
            raise RuntimeError("Dataset is empty")

    def __len__(self):
        return len(self.data) - self.start_idx

    def __getitem__(self, idx):
        data = self.data[idx + self.start_idx]
        # legacy imdb field normalization
        if "answers" not in data:
            if "all_answers" in data and "valid_answers" not in data:
                data["answers"] = data["all_answers"]
            if "valid_answers" in data:
                data["answers"] = data["valid_answers"]
        if "answers" in data and len(data["answers"]) > 0 and \
                data["answers"][-1] == "<copy>":
            data["answers"] = data["answers"][:-1]
        return data

    def get_version(self):
        return self.metadata.get("version", None)
