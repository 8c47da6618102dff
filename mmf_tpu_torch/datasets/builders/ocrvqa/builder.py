"""The OCR-VQA builder.

Port of ``mmf_tpu/datasets/builders/ocrvqa/builder.py``: TextVQA's
dataset (M4C's samples) under the name ``ocrvqa`` and its own config,
``configs/datasets/ocrvqa/defaults.yaml``.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.builders.textvqa.builder import TextVQABuilder
from mmf_tpu_torch.datasets.builders.textvqa.dataset import TextVQADataset


class OcrvqaDataset(TextVQADataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        super().__init__(config, dataset_type, imdb_file_index,
                         dataset_name="ocrvqa", *args, **kwargs)


@registry.register_builder("ocrvqa")
class OcrvqaBuilder(TextVQABuilder):
    def __init__(self, dataset_name="ocrvqa", dataset_class=OcrvqaDataset,
                 *args, **kwargs):
        super().__init__(dataset_name, dataset_class)
        self.dataset_class = OcrvqaDataset

    @classmethod
    def config_path(cls):
        return "configs/datasets/ocrvqa/defaults.yaml"
