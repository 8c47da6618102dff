"""VinVL's dataset and builder.

Port of ``mmf_tpu/datasets/builders/vinvl/builder.py``. VinVL augments
another dataset (``base_dataset_name``, VQA2 in its config): the builder
builds that dataset from ``base_dataset``, registers its answer space,
then builds ``VinVLDataset`` over the same annotations with VinVL's text
processor and ``label_map`` (the detector's ``idx_to_label`` and
``idx_to_attribute`` as a json file). An item is the base dataset's,
its ``text`` and the image's tag string (the names of the regions'
``labels`` and ``attr_labels`` from the features' info) through
``vinvl_text_tokenizer``; outside the test split two more base items,
drawn with Python's ``random``, give a random caption and a random tag
string for its corruption. As in JAX, the base dataset must give its
text under ``text`` and its features' info (``return_features_info``),
and predictions are empty rows.
"""

from __future__ import annotations

import json
import random

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.config import omega
from mmf_tpu_torch.datasets.mmf_dataset import MMFDataset
from mmf_tpu_torch.datasets.mmf_dataset_builder import MMFDatasetBuilder


class VinVLDataset(MMFDataset):
    def __init__(self, config, dataset_type, index=0, *args, **kwargs):
        name = (kwargs.pop("name", None) or kwargs.pop("dataset_name", None)
                or "vinvl")
        super().__init__(name, config, dataset_type, index, *args, **kwargs)
        self.add_tags = self._dataset_type != "test"
        self.label_map = self.load_label_map(config.get("label_map"))
        self.base_dataset = None

    def set_base_dataset(self, base_dataset):
        self.base_dataset = base_dataset

    def __len__(self):
        return len(self.annotation_db)

    def __getitem__(self, idx):
        return self.load_item(idx)

    def load_item(self, idx):
        base_sample = self.base_dataset.load_item(idx)
        argument = {"text": base_sample["text"]}
        if self.add_tags:
            argument["text_b"] = self.get_label_str(base_sample)
            caption_idx = random.randint(0, len(self.annotation_db) - 1)
            argument["random_captions"] = [
                self.base_dataset.load_item(caption_idx)["text"]]
            label_idx = random.randint(0, len(self.annotation_db) - 1)
            argument["random_labels"] = [self.get_label_str(
                self.base_dataset.load_item(label_idx))]
        base_sample.update(self.text_processor(argument))
        return base_sample

    @staticmethod
    def load_label_map(map_path):
        if map_path is None:
            return {}
        with open(map_path) as f:
            return json.load(f)

    def get_label_str(self, sample):
        """The regions' object names, a space, then their attribute
        names (an id the map lacks gives an empty name)."""
        info = sample.get("image_info_0", {}) or {}
        labels = self.label_map.get("idx_to_label", {})
        attributes = self.label_map.get("idx_to_attribute", {})
        label_str = " ".join(labels.get(str(int(i)), "")
                             for i in info.get("labels", []))
        attr_str = " ".join(attributes.get(str(int(i)), "")
                            for i in info.get("attr_labels", []))
        return label_str + " " + attr_str


@registry.register_builder("vinvl")
class VinVLBuilder(MMFDatasetBuilder):
    def __init__(self, dataset_name="vinvl", dataset_class=VinVLDataset,
                 *args, **kwargs):
        super().__init__(dataset_name, dataset_class)

    @classmethod
    def config_path(cls):
        return "configs/datasets/vinvl/defaults.yaml"

    def load(self, config, dataset_type, *args, **kwargs):
        base_name = config.get("base_dataset_name", "vqa2")
        base_config = config.get("base_dataset", config)
        base_builder_class = registry.get_builder_class(base_name)
        if base_builder_class is None:
            raise ValueError(
                f"No builder registered for VinVL's base dataset "
                f"'{base_name}'")
        base_builder = base_builder_class()
        base_builder.build_dataset(base_config, dataset_type)
        base_dataset = base_builder.load_dataset(base_config, dataset_type)
        if hasattr(base_builder, "update_registry_for_model"):
            base_builder.update_registry_for_model(base_config)

        with omega.open_dict(base_config):
            base_config["processors"]["text_processor"] = config[
                "processors"]["text_processor"]
            base_config["label_map"] = config.get("label_map")
        vinvl_dataset = super().load(base_config, dataset_type, *args,
                                     **kwargs)
        for dataset in getattr(vinvl_dataset, "datasets", [vinvl_dataset]):
            dataset.set_base_dataset(base_dataset)
        return vinvl_dataset
