"""The VQA2 builders.

Port of ``mmf_tpu/datasets/builders/vqa2/builder.py``: ``vqa2``,
``vqa2_train_val`` (train on train2014 + val2014), ``masked_vqa2`` (the
masked-LM and masked-region pretraining dataset) and ``masked_q_vqa2``
(the question cloze) and ``vqa2_ocr`` (``configs/datasets/vqa2/ocr.yaml``:
VQA2 with ``use_ocr``).
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


@registry.register_builder("vqa2_train_val")
class VQA2TrainValBuilder(VQA2Builder):
    def __init__(self, dataset_name="vqa2_train_val", *args, **kwargs):
        super().__init__(dataset_name)

    @classmethod
    def config_path(cls):
        return "configs/datasets/vqa2/train_val.yaml"


@registry.register_builder("masked_vqa2")
class MaskedVQA2Builder(VQA2Builder):
    """(reference vqa2/masked_builder.py:14-23)"""

    def __init__(self, dataset_name="masked_vqa2", *args, **kwargs):
        from mmf_tpu_torch.datasets.builders.vqa2.masked_dataset import (
            MaskedVQA2Dataset,
        )

        super().__init__(dataset_name, dataset_class=MaskedVQA2Dataset)

    @classmethod
    def config_path(cls):
        return "configs/datasets/vqa2/masked.yaml"


@registry.register_builder("masked_q_vqa2")
class MaskedQVQA2Builder(VQA2Builder):
    def __init__(self, dataset_name="masked_q_vqa2", *args, **kwargs):
        from mmf_tpu_torch.datasets.builders.vqa2.masked_dataset import (
            MaskedQVQA2Dataset,
        )

        super().__init__(dataset_name, dataset_class=MaskedQVQA2Dataset)

    @classmethod
    def config_path(cls):
        return "configs/datasets/vqa2/masked_q.yaml"


@registry.register_builder("vqa2_ocr")
class VQA2OCRBuilder(VQA2Builder):
    def __init__(self, dataset_name="vqa2_ocr", *args, **kwargs):
        super().__init__(dataset_name)

    @classmethod
    def config_path(cls):
        return "configs/datasets/vqa2/ocr.yaml"
