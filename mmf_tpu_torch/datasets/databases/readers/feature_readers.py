"""Feature readers.

Port of ``mmf_tpu/datasets/databases/readers/feature_readers.py``, with
numpy outputs: per-image ``.npy`` files (region features padded to
``max_features`` with the ``<name>_info.npy`` side file's fields
(``bbox``, ``num_boxes``, the image size, ...), and grid features in
their 2-, 3- and 4-d layouts), and LMDB environments (``.lmdb`` paths):
the pickled per-image dicts of MMF's feature zoo, read through the
port's native LMDB core (``utils/native/lmdb_shim``), never the ``lmdb``
package.
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np


def load_feat(path):
    return np.load(path, allow_pickle=True)


class FasterRCNNFeatureReader:
    def read(self, image_feat_path):
        return load_feat(image_feat_path), None


class CHWFeatureReader:
    def __init__(self, max_features=None):
        self.max_features = max_features
        if self.max_features:
            patch_dim = math.ceil(math.sqrt(self.max_features))
            self.img_h = patch_dim
            self.img_w = patch_dim

    def read(self, image_feat_path):
        feat = load_feat(image_feat_path)
        assert feat.shape[0] == 1, "batch dimension must be 1"
        if self.max_features:
            b, c, h, w = feat.shape
            padded = np.zeros((b, c, self.img_h, self.img_w), np.float32)
            padded[:, :, :h, :w] = feat
            feat = padded
        return feat[0], None


class Dim3FeatureReader:
    def read(self, image_feat_path):
        tmp = load_feat(image_feat_path)
        _, _, c_dim = tmp.shape
        return np.reshape(tmp, (-1, c_dim)), None


class HWCFeatureReader:
    def read(self, image_feat_path):
        tmp = load_feat(image_feat_path)
        assert tmp.shape[0] == 1, "batch dimension must be 1"
        _, _, _, c_dim = tmp.shape
        return np.reshape(tmp, (-1, c_dim)), None


class PaddedFasterRCNNFeatureReader:
    """Pads region features to max_loc and extracts info side files
    (reference feature_readers.py:141-215)."""

    def __init__(self, max_loc):
        self.max_loc = max_loc
        self.first = True
        self.take_item = False

    def _load(self, image_feat_path):
        image_info = {"features": load_feat(image_feat_path)}
        info_path = "{}_info.npy".format(image_feat_path.split(".npy")[0])
        if os.path.exists(info_path):
            image_info.update(load_feat(info_path).item())
        return image_info

    def read(self, image_feat_path):
        image_info = self._load(image_feat_path)
        if self.first:
            self.first = False
            if (
                image_info["features"].size == 1
                and "image_feat" in image_info["features"].item()
            ):
                self.take_item = True

        image_feature = image_info["features"]
        if self.take_item:
            item = image_info["features"].item()
            if "image_text" in item:
                image_info["image_text"] = item["image_text"]
                image_info["is_ocr"] = item["image_bbox_source"]
                image_feature = item["image_feat"]
            if "info" in item:
                if "image_text" in item["info"]:
                    image_info.update(item["info"])
                image_feature = item["feature"]

        if (
            image_info["features"].size == 1
            and "features" in image_info["features"].item()
        ):
            item = image_info["features"].item()
            image_feature = item["features"]
            image_info["image_height"] = item["image_height"]
            image_info["image_width"] = item["image_width"]
            image_loc, _ = image_feature.shape
            image_info["cls_prob"] = np.zeros(
                (self.max_loc, item["cls_prob"].shape[1]), np.float32
            )
            image_info["cls_prob"][0:image_loc] = item["cls_prob"][
                : self.max_loc, :
            ]
            image_info["bbox"] = np.zeros(
                (self.max_loc, item["bbox"].shape[1]), np.float32
            )
            image_info["bbox"][0:image_loc] = item["bbox"][: self.max_loc, :]
            image_info["num_boxes"] = item["num_boxes"]

        if len(image_feature.shape) > 2:  # grid features (e.g. ResNet152)
            shape = image_feature.shape
            image_feature = image_feature.reshape(-1, shape[-1])

        image_loc, image_dim = image_feature.shape
        tmp = np.zeros((self.max_loc, image_dim), np.float32)
        tmp[0:image_loc] = image_feature[: self.max_loc, :]
        del image_info["features"]
        image_info["max_features"] = np.int64(min(image_loc, self.max_loc))
        return tmp, image_info


def _lmdb_module():
    """The native LMDB core (``utils/native/lmdb_shim``), built at first
    use; raises where no C++ compiler works."""
    from mmf_tpu_torch.utils.native import lmdb_shim

    lmdb_shim.library()
    return lmdb_shim


class LMDBFeatureReader(PaddedFasterRCNNFeatureReader):
    """LMDB-backed reader with lazy env init (reference
    feature_readers.py:218-265). The environment holds ``b"keys"``, the
    pickled list of image keys, and one pickled feature dict per key; an
    image is looked up by the int after the path's last ``_`` first,
    then by its path (without ``.npy``) relative to the database."""

    def __init__(self, max_loc, base_path):
        super().__init__(max_loc)
        self.db_path = base_path
        _lmdb_module()  # raise early when the core cannot be built
        if not os.path.exists(self.db_path):
            raise RuntimeError(
                f"{self.db_path} path specified for LMDB features doesn't "
                "exist."
            )
        self.env = None

    def _init_db(self):
        lmdb = _lmdb_module()
        self.env = lmdb.open(
            self.db_path, subdir=os.path.isdir(self.db_path), readonly=True,
            lock=False, readahead=False, meminit=False,
        )
        with self.env.begin(write=False, buffers=True) as txn:
            self.image_ids = pickle.loads(txn.get(b"keys"))
            self.image_id_indices = {
                self.image_ids[i]: i for i in range(len(self.image_ids))
            }

    def _load(self, image_file_path):
        if self.env is None:
            self._init_db()
        split = os.path.relpath(image_file_path,
                                self.db_path).split(".npy")[0]
        try:
            image_id = int(split.split("_")[-1])
            img_id_idx = self.image_id_indices[str(image_id).encode()]
        except (ValueError, KeyError):
            image_id = split
            img_id_idx = self.image_id_indices[image_id.encode()]
        with self.env.begin(write=False, buffers=True) as txn:
            return pickle.loads(txn.get(self.image_ids[img_id_idx]))


class FeatureReader:
    """Dispatcher by lmdb path or the features' ndim (reference
    feature_readers.py:28-95)."""

    def __init__(self, base_path, depth_first, max_features=None, ndim=None):
        self.base_path = base_path
        self.feat_reader = None
        self.depth_first = depth_first
        self.max_features = max_features
        self.ndim = ndim

    def _init_reader(self):
        if self.base_path.endswith(".lmdb"):
            self.feat_reader = LMDBFeatureReader(self.max_features,
                                                 self.base_path)
        elif self.ndim == 2 or self.ndim == 0:
            if self.max_features is None:
                self.feat_reader = FasterRCNNFeatureReader()
            else:
                self.feat_reader = PaddedFasterRCNNFeatureReader(
                    self.max_features
                )
        elif self.ndim == 3 and not self.depth_first:
            self.feat_reader = Dim3FeatureReader()
        elif self.ndim == 4 and self.depth_first:
            self.feat_reader = CHWFeatureReader(self.max_features)
        elif self.ndim == 4 and not self.depth_first:
            self.feat_reader = HWCFeatureReader()
        else:
            raise TypeError("unknown image feature format")

    def read(self, image_feat_path):
        if not image_feat_path.endswith(".npy"):
            return None
        image_feat_path = os.path.join(self.base_path, image_feat_path)
        if self.feat_reader is None:
            if self.ndim is None and not self.base_path.endswith(".lmdb"):
                self.ndim = load_feat(image_feat_path).ndim
            self._init_reader()
        return self.feat_reader.read(image_feat_path)
