"""The Hateful Memes builder.

Port of ``mmf_tpu/datasets/builders/hateful_memes/builder.py``:
``hateful_memes`` loads ``HatefulMemesFeaturesDataset`` when the config
has ``use_features``, else ``HatefulMemesImageDataset``.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.builders.hateful_memes.dataset import (
    HatefulMemesFeaturesDataset,
    HatefulMemesImageDataset,
)
from mmf_tpu_torch.datasets.mmf_dataset_builder import MMFDatasetBuilder


@registry.register_builder("hateful_memes")
class HatefulMemesBuilder(MMFDatasetBuilder):
    def __init__(self, dataset_name="hateful_memes",
                 dataset_class=HatefulMemesImageDataset, *args, **kwargs):
        super().__init__(dataset_name, dataset_class)

    @classmethod
    def config_path(cls):
        return "configs/datasets/hateful_memes/defaults.yaml"

    def load(self, config, dataset_type, *args, **kwargs):
        self.dataset_class = (HatefulMemesFeaturesDataset
                              if config.get("use_features", False)
                              else HatefulMemesImageDataset)
        return super().load(config, dataset_type, *args, **kwargs)

    def update_registry_for_model(self, config):
        """Register the fine-grained answer space for other layers."""
        dataset = getattr(self, "dataset", None)
        if dataset is not None and hasattr(dataset, "answer_processor"):
            registry.register(
                self.dataset_name + "_num_final_outputs",
                dataset.answer_processor.get_vocab_size(),
            )
