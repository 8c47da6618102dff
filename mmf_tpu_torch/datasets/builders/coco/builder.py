"""The COCO builders.

Port of ``mmf_tpu/datasets/builders/coco/builder.py``: ``coco`` (the
captioning dataset of ``configs/datasets/coco/defaults.yaml``) and
``masked_coco`` (the masked-LM pretraining dataset of
``configs/datasets/coco/masked.yaml``, which UNITER, VisualBERT and ViLT
pretrain on). Features come through the features database (an LMDB, or
a folder of ``.npy`` files). The other ``masked_*`` caption datasets
that share the masked dataset wait for their builders.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.builders.coco.dataset import COCODataset
from mmf_tpu_torch.datasets.mmf_dataset_builder import MMFDatasetBuilder


@registry.register_builder("coco")
class COCOBuilder(MMFDatasetBuilder):
    def __init__(self, dataset_name="coco", dataset_class=COCODataset,
                 *args, **kwargs):
        super().__init__(dataset_name, dataset_class)

    @classmethod
    def config_path(cls):
        return "configs/datasets/coco/defaults.yaml"

    def update_registry_for_model(self, config):
        """The text vocabulary's size and the caption processor, for the
        models and the prediction rows."""
        dataset = getattr(self, "dataset", None)
        if dataset is None:
            return
        if hasattr(dataset, "text_processor") and hasattr(
                dataset.text_processor, "get_vocab_size"):
            registry.register(self.dataset_name + "_text_vocab_size",
                              dataset.text_processor.get_vocab_size())
        if hasattr(dataset, "caption_processor"):
            registry.register("coco_caption_processor",
                              dataset.caption_processor)


@registry.register_builder("masked_coco")
class MaskedCOCOBuilder(COCOBuilder):
    def __init__(self, dataset_name="masked_coco", *args, **kwargs):
        from mmf_tpu_torch.datasets.builders.coco.masked_dataset import (
            MaskedCOCODataset,
        )

        super().__init__(dataset_name, dataset_class=MaskedCOCODataset)

    @classmethod
    def config_path(cls):
        return "configs/datasets/coco/masked.yaml"
