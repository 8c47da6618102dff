"""The VizWiz builder.

Port of ``mmf_tpu/datasets/builders/vizwiz/builder.py``: VizWiz is a
VQA2-format dataset (imdb annotations, region features, ten answers a
question) under its own config tree (``configs/datasets/vizwiz/
defaults.yaml``), named ``vizwiz`` in the registry and in its reports.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.builders.vqa2.builder import VQA2Builder
from mmf_tpu_torch.datasets.builders.vqa2.dataset import VQA2Dataset


class VizwizDataset(VQA2Dataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        super().__init__(config, dataset_type, imdb_file_index,
                         dataset_name="vizwiz", *args, **kwargs)


@registry.register_builder("vizwiz")
class VizwizBuilder(VQA2Builder):
    def __init__(self, dataset_name="vizwiz", dataset_class=VizwizDataset,
                 *args, **kwargs):
        super().__init__(dataset_name, dataset_class)
        self.dataset_class = VizwizDataset

    @classmethod
    def config_path(cls):
        return "configs/datasets/vizwiz/defaults.yaml"
