"""The VQA2 builder.

Port of ``VQA2Builder`` from ``mmf_tpu/datasets/builders/vqa2/
builder.py``. The masked, OCR and train-val variants are not ported yet.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.builders.vqa2.dataset import VQA2Dataset
from mmf_tpu_torch.datasets.mmf_dataset_builder import MMFDatasetBuilder


@registry.register_builder("vqa2")
class VQA2Builder(MMFDatasetBuilder):
    def __init__(self, dataset_name="vqa2", dataset_class=VQA2Dataset,
                 *args, **kwargs):
        super().__init__(dataset_name, dataset_class)

    @classmethod
    def config_path(cls):
        return "configs/datasets/vqa2/defaults.yaml"

    def load(self, *args, **kwargs):
        dataset = super().load(*args, **kwargs)
        if dataset is not None and hasattr(dataset, "try_fast_read"):
            dataset.try_fast_read()
        return dataset

    def update_registry_for_model(self, config):
        """Register the answer space for other layers (models, metrics)."""
        dataset = getattr(self, "dataset", None)
        if dataset is None:
            return
        if hasattr(dataset, "text_processor"):
            registry.register(
                self.dataset_name + "_text_vocab_size",
                dataset.text_processor.get_vocab_size(),
            )
        if hasattr(dataset, "answer_processor"):
            registry.register(
                self.dataset_name + "_num_final_outputs",
                dataset.answer_processor.get_vocab_size(),
            )
            registry.register(
                self.dataset_name + "_answer_processor",
                dataset.answer_processor,
            )
