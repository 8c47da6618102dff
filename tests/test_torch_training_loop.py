"""The port's MMFTrainer loop, the cases of
``tests/trainers/test_training_loop.py`` on the port's own fixtures: a
registered linear ``simple_model`` and the ``numbers`` dataset (i ->
x = y = i) driving the real trainer on the CPU. The counts are JAX's:
6 updates of a half epoch, 24 updates in 2 epochs, 8 with
update_frequency 4, the update_frequency equivalence, the evaluation
loop and train-time metrics with accumulation, the NaN guard and a user
callback from the config."""

import numpy as np
import pytest
import torch

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.common.sample import Sample
from mmf_tpu_torch.config import omega
from mmf_tpu_torch.config.configuration import Configuration
from mmf_tpu_torch.datasets.base_dataset import BaseDataset
from mmf_tpu_torch.datasets.base_dataset_builder import BaseDatasetBuilder
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.trainers.callbacks.base import Callback
from mmf_tpu_torch.trainers.mmf_trainer import build_trainer
from mmf_tpu_torch.utils.env import setup_imports

setup_imports()

DATA_ITEM_KEY = "data"


if registry.get_model_class("simple_model") is None:

    @registry.register_model("simple_model")
    class SimpleModel(BaseModel):
        """Linear regression (reference tests/test_utils.py:194)."""

        def __init__(self, config):
            super().__init__(config)
            size = config.get("in_dim", 1)
            self.classifier = torch.nn.Linear(size, size)

        def forward(self, sample_list):
            return {"scores": self.classifier(sample_list[DATA_ITEM_KEY])}


class NumbersDataset(BaseDataset):
    """i -> (x = i * ones, y = x) (reference tests/test_utils.py:167)."""

    def __init__(self, num_examples=100, dataset_type="train", in_dim=1):
        super().__init__("numbers", {}, dataset_type)
        self.num_examples = num_examples
        self.in_dim = in_dim

    def load_item(self, idx):
        s = Sample()
        s[DATA_ITEM_KEY] = np.full((self.in_dim,), idx, np.float32)
        s["targets"] = np.full((self.in_dim,), idx, np.float32)
        return s

    def __len__(self):
        return self.num_examples


if registry.get_builder_class("numbers") is None:

    @registry.register_builder("numbers")
    class NumbersDatasetBuilder(BaseDatasetBuilder):
        def __init__(self):
            super().__init__("numbers")

        def build(self, config, dataset_type="train", *args, **kwargs):
            return

        def load(self, config, dataset_type="train", *args, **kwargs):
            return NumbersDataset(config.get("num_examples", 100),
                                  dataset_type=dataset_type)


if registry.get_callback_class("port_counter_callback") is None:

    @registry.register_callback("port_counter_callback")
    class CounterCallback(Callback):
        last_instance = None

        def __init__(self, config, trainer, boost=1):
            super().__init__(config, trainer)
            self.boost = boost
            self.counts = {"train_start": 0, "update_end": 0}
            CounterCallback.last_instance = self

        def on_train_start(self, **kwargs):
            self.counts["train_start"] += 1

        def on_update_end(self, **kwargs):
            self.counts["update_end"] += self.boost


@pytest.fixture(autouse=True)
def _restore_port_registry():
    state = dict(registry.mapping["state"])
    yield
    registry.mapping["state"].clear()
    registry.mapping["state"].update(state)


def make_trainer(save_dir, callbacks=None, **overrides):
    opts = {
        "model": "simple_model", "datasets": "numbers",
        "training.batch_size": 8, "training.max_updates": 6,
        "training.max_epochs": "null", "training.log_interval": 2,
        "training.checkpoint_interval": 1000000,
        "training.evaluation_interval": 1000000,
        "training.num_workers": 0, "training.seed": 1,
        "training.device": "cpu", "optimizer.type": "sgd",
        "optimizer.params.lr": 0.00001, "run_type": "train",
        "env.save_dir": save_dir,
    }
    num_examples = overrides.pop("num_examples", 100)
    opts.update(overrides)
    config = Configuration([f"{k}={v}" for k, v in opts.items()]).get_config()
    with omega.open_dict(config):
        config["model_config"]["simple_model"] = {
            "in_dim": 1, "losses": [{"type": "mse"}]}
        config["dataset_config"]["numbers"] = {"num_examples": num_examples}
        if callbacks:
            config["training"]["callbacks"] = callbacks
    registry.register("config", config)
    trainer = build_trainer(config)
    trainer.load()
    return trainer


@pytest.mark.parametrize("overrides, updates, epochs", [
    # 100 examples / batch 8 = 12 batches an epoch: 6 updates, half of one
    ({}, 6, 1),
    # 2 epochs = 24 updates
    ({"training.max_updates": "null", "training.max_epochs": 2}, 24, 2),
    # one loader batch is one update (update_frequency splits it into
    # microbatches): 32 examples / batch 8 = 4 updates an epoch, x 2
    ({"training.max_updates": "null", "training.max_epochs": 2,
      "training.update_frequency": 4, "num_examples": 32}, 8, 2),
])
def test_update_and_epoch_counts(tmp_path, overrides, updates, epochs):
    trainer = make_trainer(str(tmp_path), **overrides)
    trainer.train()
    assert trainer.num_updates == updates
    assert trainer.current_iteration == updates * overrides.get(
        "training.update_frequency", 1)
    assert trainer.current_epoch == epochs


def test_loss_decreases(tmp_path):
    trainer = make_trainer(str(tmp_path), **{
        "training.max_updates": 60, "optimizer.params.lr": 0.00005})
    trainer.train()
    sv = trainer.meter.meters["train/numbers/mse"]
    assert sv.get_latest() <= sv.global_avg * 1.5


def test_update_frequency_equivalence(tmp_path):
    """(batch 8 split into 2 microbatches) and (batch 8 whole) from the
    same seed give the same parameters (reference
    test_training_loop.py:21-94)."""
    weights = []
    for uf in (2, 1):
        trainer = make_trainer(str(tmp_path / f"uf{uf}"), **{
            "training.update_frequency": uf, "training.max_updates": 3,
            "training.seed": 7})
        trainer.train()
        weights.append(trainer.model.classifier.weight.detach().numpy())
    np.testing.assert_allclose(weights[0], weights[1], atol=1e-5)


def test_evaluation_loop_runs(tmp_path):
    trainer = make_trainer(str(tmp_path), **{"training.max_updates": 2})
    trainer.train()
    report, meter = trainer.evaluation_loop("val")
    assert "val/numbers/mse" in meter.meters
    # 100 examples in batches of 8: the last padded to 8, trimmed to 4
    assert report.batch_size == 100


@pytest.mark.parametrize("update_frequency, log_interval", [(1, 2), (2, 1)])
def test_evaluate_metrics_during_training(tmp_path, update_frequency,
                                          log_interval):
    """``training.evaluate_metrics``: metrics of the train batch at each
    log interval (reference training_loop.py:118-123), with the scores
    gathered over the microbatches."""
    trainer = make_trainer(str(tmp_path), **{
        "training.max_updates": 4, "training.log_interval": log_interval,
        "training.update_frequency": update_frequency,
        "training.evaluate_metrics": True,
        "evaluation.metrics[0]": "accuracy"})
    trainer.train()
    assert "train/numbers/accuracy" in trainer.meter.meters


def test_nan_guard(tmp_path):
    trainer = make_trainer(str(tmp_path), **{
        "training.max_updates": 3, "optimizer.params.lr": 1e20,
        "training.log_interval": 1})
    with pytest.raises(RuntimeError, match="NaN"):
        trainer.train()


def test_user_callback_from_config(tmp_path):
    """A callback registered with ``@registry.register_callback`` and
    named in ``training.callbacks`` is built with its params and hears
    the hooks (reference tests/trainers/callbacks/test_user_callback.py)."""
    trainer = make_trainer(
        str(tmp_path), callbacks=[{"type": "port_counter_callback",
                                   "params": {"boost": 2}}],
        **{"training.max_updates": 4})
    trainer.train()
    cb = registry.get_callback_class("port_counter_callback").last_instance
    assert cb is not None and cb.boost == 2
    assert cb.counts["train_start"] == 1
    # 4 updates x boost 2: the params reached the constructor
    assert cb.counts["update_end"] == 8


def test_profile_dir_writes_a_trace(tmp_path):
    """``training.profile_dir``: a torch.profiler trace of the training
    loop, and the profiling mixin's timing points of every update."""
    trainer = make_trainer(str(tmp_path), **{
        "training.max_updates": 2,
        "training.profile_dir": str(tmp_path / "trace")})
    trainer.train()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    meters = trainer.profile_meter.meters
    for point in ("Batch prepare time", "Step dispatch time",
                  "Finished update"):
        assert len(meters[point].averaged_value_deque) == 2, point
