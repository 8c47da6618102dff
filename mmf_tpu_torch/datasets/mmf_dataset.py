"""MMFDataset: an annotation database plus a features database and/or
an image database.

Port of ``mmf_tpu/datasets/mmf_dataset.py``: ``use_features`` reads
region features, ``use_images`` reads images from the split's
``images`` folder (``ImageDatabase``; a dataset sets its
``image_processor`` as the database's transform).
"""

from __future__ import annotations

import os

from mmf_tpu_torch.datasets.base_dataset import BaseDataset
from mmf_tpu_torch.datasets.databases.annotation_database import (
    AnnotationDatabase,
)
from mmf_tpu_torch.datasets.databases.features_database import (
    FeaturesDatabase,
)
from mmf_tpu_torch.datasets.databases.image_database import ImageDatabase
from mmf_tpu_torch.utils.general import get_absolute_path


class MMFDataset(BaseDataset):
    def __init__(self, dataset_name, config, dataset_type="train",
                 index=0, *args, **kwargs):
        super().__init__(dataset_name, config, dataset_type)
        self._index = index
        self.annotation_db = self.build_annotation_db()

        self._use_images = self.config.get("use_images", False)
        if self._use_images:
            self.image_db = self.build_image_db()
        self._use_features = self.config.get("use_features", False)
        if self._use_features:
            self.features_db = self.build_features_db()

    def build_annotation_db(self) -> AnnotationDatabase:
        annotation_path = self._get_path_based_on_index(
            self.config, "annotations", self._index
        )
        return AnnotationDatabase(self.config, annotation_path)

    def build_features_db(self) -> FeaturesDatabase:
        features_path = self._get_path_based_on_index(
            self.config, "features", self._index
        )
        return FeaturesDatabase(
            self.config, features_path, annotation_db=self.annotation_db
        )

    def build_image_db(self) -> ImageDatabase:
        image_path = self._get_path_based_on_index(
            self.config, "images", self._index
        )
        return ImageDatabase(
            self.config, image_path, annotation_db=self.annotation_db
        )

    def _process_feature_info(self, features):
        """Run the bbox geometry processor over image_info_0 when one is
        configured."""
        if hasattr(self, "transformer_bbox_processor"):
            features["image_info_0"] = self.transformer_bbox_processor(
                features["image_info_0"]
            )
        return features

    def add_masked_features(self, idx, sample):
        """The masked-pretraining feature path: the region features, the
        box geometry processor over their info and, with
        ``use_image_feature_masks``, the masked features and their
        ``image_labels`` from ``masked_region_processor``."""
        features = self._process_feature_info(self.features_db[idx])
        if self.config.get("use_image_feature_masks", False):
            masked, labels = self.masked_region_processor(
                features["image_feature_0"])
            features["image_feature_0"] = masked
            sample["image_labels"] = labels
        sample.update(features)
        return sample

    def _get_path_based_on_index(self, config, attribute, index):
        """The ``index``-th path of this split's ``attribute`` list,
        under the dataset's ``data_dir`` (reference mmf_dataset.py:60-89)."""
        if attribute not in config:
            raise ValueError(f"{attribute} not present in config")
        config = config.get(attribute, None)
        if (
            self.dataset_type not in config
            or len(config.get(self.dataset_type, [])) == 0
        ):
            raise ValueError(
                f"No {attribute} present for type {self.dataset_type}")
        paths = config[self.dataset_type]
        if isinstance(paths, str):
            selected_path = paths
        else:
            selected_path = paths[index]
        return self._add_root_dir(selected_path)

    def _add_root_dir(self, path):
        path = path.split(",")
        data_dir = self.config.get("data_dir", None)
        for idx, p in enumerate(path):
            if not os.path.isabs(p) and data_dir:
                p = os.path.join(data_dir, p)
            path[idx] = get_absolute_path(p)
        return ",".join(path)

    def __len__(self):
        return len(self.annotation_db)
