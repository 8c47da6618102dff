"""MultiDataModule: the trainer's view of all configured datasets.

Port of ``mmf_tpu/datasets/multi_datamodule.py``: one builder per dataset
in ``config.datasets``, train/val/test ``MultiDataLoader``s with the
configured iteration strategy, and the trainer hooks
(``get_test_reporter``, ``prepare_batch``, ``seed_sampler``).
"""

from __future__ import annotations

import logging
from typing import Dict, List

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.common.sample import SampleList
from mmf_tpu_torch.datasets import iteration_strategies
from mmf_tpu_torch.datasets.multi_dataloader import MultiDataLoader

logger = logging.getLogger(__name__)


def dataset_list_from_config(config) -> List[str]:
    if "datasets" not in config:
        logger.warning("No datasets attribute present. Setting default to vqa2.")
        datasets = "vqa2"
    else:
        datasets = config["datasets"]
    if isinstance(datasets, str):
        datasets = list(map(lambda x: x.strip(), datasets.split(",")))
    return list(datasets)


def build_datamodules(config) -> Dict[str, object]:
    """Instantiate + prepare each dataset's builder
    (reference utils/build.py:238-261)."""
    dataset_list = dataset_list_from_config(config)
    datamodules = {}
    for dataset in dataset_list:
        builder_cls = registry.get_builder_class(dataset)
        if builder_cls is None:
            raise RuntimeError(
                f"Key {dataset} doesn't have a registered dataset builder"
            )
        builder = builder_cls()
        dataset_config = config["dataset_config"].get(dataset, {})
        builder.prepare_data(dataset_config)
        builder.setup(dataset_config)
        # cross-layer metadata: answer-vocab sizes etc. (the M4C pattern)
        if hasattr(builder, "update_registry_for_model"):
            builder.update_registry_for_model(dataset_config)
        datamodules[dataset] = builder
    return datamodules


def _build_iteration_strategy(config, dataloaders) -> iteration_strategies.IterationStrategy:
    training = config.get("training", {})
    multitasking = config.get("multitasking", {}) or {}
    enabled = multitasking.get("enabled", True)
    size_proportional = training.get("dataset_size_proportional_sampling", True)
    if len(dataloaders) <= 1:
        return iteration_strategies.ConstantIterationStrategy({}, dataloaders)
    if not enabled:
        return iteration_strategies.RoundRobinIterationStrategy({}, dataloaders)
    mtype = multitasking.get("type", None)
    if mtype is None:
        mtype = "size_proportional" if size_proportional else "round_robin"
    strategy_cls = registry.get_iteration_strategy_class(mtype)
    if strategy_cls is None:
        raise ValueError(f"No iteration strategy '{mtype}' registered")
    return strategy_cls(multitasking.get("params", {}), dataloaders)


class MultiDataModule:
    def __init__(self, config):
        self.config = config
        self.datamodules = build_datamodules(config)
        self._train_loader = None
        self._val_loader = None
        self._test_loader = None

    def _build_multi_dataloader(self, dataset_type: str = "train") -> MultiDataLoader:
        loaders = {}
        for key, dm in self.datamodules.items():
            # datasets without this split load as None ("This dataset
            # won't be used"); honor that instead of crashing in the
            # sampler on len(None)
            if getattr(dm, f"{dataset_type}_dataset", "missing") is None:
                continue
            loader = getattr(dm, f"{dataset_type}_dataloader")()
            if not hasattr(loader, "dataset"):
                loader.dataset = getattr(dm, f"{dataset_type}_dataset", None)
            loaders[key] = loader
        if dataset_type == "train":
            strategy = _build_iteration_strategy(self.config, loaders)
        else:
            # eval rotates loaders and EXHAUSTS each exactly once
            # (exhaust_all; without it RoundRobin reignites finished
            # iterators and a multi-dataset eval epoch never ends)
            if len(loaders) <= 1:
                strategy = iteration_strategies.ConstantIterationStrategy(
                    {}, loaders
                )
            else:
                strategy = iteration_strategies.RoundRobinIterationStrategy(
                    {"skip_epoch_check": True, "exhaust_all": True}, loaders
                )
        return MultiDataLoader(loaders, strategy)

    def train_dataloader(self) -> MultiDataLoader:
        if self._train_loader is None:
            self._train_loader = self._build_multi_dataloader("train")
        return self._train_loader

    def val_dataloader(self) -> MultiDataLoader:
        if self._val_loader is None:
            self._val_loader = self._build_multi_dataloader("val")
        return self._val_loader

    def test_dataloader(self) -> MultiDataLoader:
        if self._test_loader is None:
            self._test_loader = self._build_multi_dataloader("test")
        return self._test_loader

    # -- trainer hooks (reference multi_datamodule.py:90-109) ------------
    def get_test_reporter(self, dataset_type: str):
        test_reporter_config = self._get_test_reporter_config()
        test_reporter_cls = registry.get_test_reporter_class(
            test_reporter_config.get("type", "file")
        )
        return test_reporter_cls(
            self.datamodules, test_reporter_config.get("params", {}), dataset_type
        )

    def _get_test_reporter_config(self):
        evaluation = self.config.get("evaluation", {}) or {}
        return evaluation.get("reporter", {"type": "file", "params": {}}) or {
            "type": "file", "params": {}
        }

    def prepare_batch(self, batch: SampleList) -> SampleList:
        return batch

    def seed_sampler(self, dataset_type: str, seed: int):
        loader = getattr(self, f"{dataset_type}_dataloader")()
        loader.seed_sampler(seed)

    def teardown(self):
        for loader in (self._train_loader, self._val_loader,
                       self._test_loader):
            if loader is not None:
                loader.teardown()
        for dm in self.datamodules.values():
            dm.teardown()
