"""The ST-VQA builder.

Port of ``mmf_tpu/datasets/builders/stvqa/builder.py``: TextVQA's
dataset (M4C's samples) under the name ``stvqa`` and its own config,
``configs/datasets/stvqa/defaults.yaml``. The TextVQA dataset prefixes
an ST-VQA annotation's ``feature_path`` with its split's folder.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.builders.textvqa.builder import TextVQABuilder
from mmf_tpu_torch.datasets.builders.textvqa.dataset import TextVQADataset


class StvqaDataset(TextVQADataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        super().__init__(config, dataset_type, imdb_file_index,
                         dataset_name="stvqa", *args, **kwargs)


@registry.register_builder("stvqa")
class StvqaBuilder(TextVQABuilder):
    def __init__(self, dataset_name="stvqa", dataset_class=StvqaDataset,
                 *args, **kwargs):
        super().__init__(dataset_name, dataset_class)
        self.dataset_class = StvqaDataset

    @classmethod
    def config_path(cls):
        return "configs/datasets/stvqa/defaults.yaml"
