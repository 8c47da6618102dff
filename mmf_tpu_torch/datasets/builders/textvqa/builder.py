"""The TextVQA builder.

Port of ``mmf_tpu/datasets/builders/textvqa/builder.py``: ``textvqa``
loads ``TextVQADataset`` and registers ``textvqa_text_vocab_size``,
``textvqa_num_final_outputs`` (the answer vocabulary plus the OCR copy
slots, which M4C's classifier reads) and ``textvqa_answer_processor``
(which ``textvqa_accuracy`` and the predictions read).
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.builders.textvqa.dataset import TextVQADataset
from mmf_tpu_torch.datasets.mmf_dataset_builder import MMFDatasetBuilder


@registry.register_builder("textvqa")
class TextVQABuilder(MMFDatasetBuilder):
    def __init__(self, dataset_name="textvqa", dataset_class=TextVQADataset,
                 *args, **kwargs):
        super().__init__(dataset_name, dataset_class)

    @classmethod
    def config_path(cls):
        return "configs/datasets/textvqa/defaults.yaml"

    def update_registry_for_model(self, config):
        dataset = getattr(self, "dataset", None)
        if dataset is None:
            return
        if hasattr(dataset, "text_processor") and hasattr(
                dataset.text_processor, "get_vocab_size"):
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
