"""``mmf_run`` on Hateful Memes: MMBT from
``projects/hateful_memes/configs/mmbt/defaults.yaml`` (a 2-layer text
encoder of 64, f32, dropout 0, batch 8: JAX's CPU mesh has 8 devices)
trained 4 updates, evaluated on ``accuracy``, ``binary_f1`` and
``roc_auc`` (early stopping on ``roc_auc``, maximised), and predicting
csv rows ``id,proba,label``, on the synthetic layout
(``tests/torch_hm_layout.py``: PNG memes, ``train.jsonl``,
``dev_unseen.jsonl``, ``test_unseen.jsonl``, npy region features).

- Against JAX's ``mmf_run``, both in the process, on the same layout and
  initial weights, over the features dataset (``use_features``,
  ``direct_features_input``): the losses at each update within 2e-4
  relative, the val metrics within 1e-4, the csv files' ids and labels
  equal and their probabilities within 1e-4, the run folders' file names
  equal, and the schedule's ``num_training_steps``
  (``'${training.max_updates}'``) a number in both.
- The port alone over raw images (ResNet-152 on 32 px crops, its
  BatchNorm statistics trained): the same reports and files, finite.
  JAX's run of it is not compared: a ResNet-152 in training mode
  carries f32 rounding that differs between the frameworks to 0.1 of
  its features at this size (``tests/torch_hm_models.py``, which holds
  the two in float64), and JAX's run of it takes minutes to compile.

The weights are drawn as in ``tests/torch_hm_models.py``; JAX starts
from a native checkpoint of them, the port from the same weights carried
across by ``params_from_jax`` into a torch file.
"""

import csv
import glob
import logging
import os
import re
import warnings

import jax
import numpy as np
import pytest
import torch

from tests import torch_hm_models as hm
from tests.torch_hm_layout import layout_opts, write_layout
from tests.torch_port_utils import registries_restored

torch.set_num_threads(2)  # several test workers share the host

UPDATES = 4
LOSS_RTOL = 2e-4
LOSS_KEY = "train/hateful_memes/cross_entropy"
SMALL_IMAGES = ("dataset_config.hateful_memes.processors.image_processor."
                "params.transforms=[{type: Resize, params: {size: [40, 40]}},"
                " {type: CenterCrop, params: {size: [32, 32]}}, ToTensor, "
                "GrayScaleTo3Channels, {type: Normalize, params: {mean: "
                "[0.46777044, 0.44531429, 0.40661017], std: [0.12221994, "
                "0.12145835, 0.14380469]}}]")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hateful_memes_run"))
    write_layout(root, n_train=16, n_val=12, n_test=6, n_images=8,
                 vocab_size=hm.VOCAB, seed=0, features=True,
                 regions=hm.REGIONS, feature_dim=hm.FEATURE_DIM)
    return root


@pytest.fixture(scope="module", autouse=True)
def _restore_global_state():
    """Both CLIs install logging handlers and fill their registries:
    the runs start from empty registries and everything is put back
    after the module; dropout 0 in both packages' text encoders (no
    config key reaches it)."""
    loggers = [logging.getLogger(n) for n in ("mmf_tpu", "mmf_tpu_torch",
                                               "py.warnings")]
    saved = [(lg, list(lg.handlers), lg.level, lg.propagate)
             for lg in loggers]
    with registries_restored(empty=True), warnings.catch_warnings(), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(*hm.jax_no_dropout())
        mp.setattr(*hm.jax_no_dropout("mmf_tpu_torch"))
        yield
    for lg, handlers, level, propagate in saved:
        for h in lg.handlers:
            if h not in handlers:
                h.close()
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate
    logging.captureWarnings(False)


FEATURES = [
    "dataset_config.hateful_memes.use_features=true",
    "dataset_config.hateful_memes.use_images=false",
    f"dataset_config.hateful_memes.max_features={hm.REGIONS}",
    "model_config.mmbt.direct_features_input=true",
    f"model_config.mmbt.modal_hidden_size={hm.FEATURE_DIM}",
] + [f"dataset_config.hateful_memes.features.{s}="
     "[hateful_memes/defaults/features]" for s in ("train", "val", "test")]


def _opts(layout, save_dir, *extra):
    text = "model_config.mmbt.text_encoder.params"
    return [
        "config=projects/hateful_memes/configs/mmbt/defaults.yaml",
        "model=mmbt", "dataset=hateful_memes", "training.device=cpu",
        f"env.save_dir={save_dir}", "training.batch_size=8",
        f"training.max_updates={UPDATES}", "training.evaluation_interval=2",
        "training.checkpoint_interval=2", "training.log_interval=1",
        "training.num_workers=0", "training.seed=1",
        "scheduler.params.num_warmup_steps=1",
        "run_type=train_val_inference", "evaluation.predict=true",
        "model_config.mmbt.dtype=float32",
        "dataset_config.hateful_memes.processors.text_processor.params."
        "max_seq_length=16", SMALL_IMAGES,
    ] + [f"{text}.{k}={v}" for k, v in hm.SMALL_TEXT.items()] + \
        layout_opts(layout) + list(extra)


@pytest.fixture(scope="module")
def initial_weights(tmp_path_factory):
    """(JAX's native checkpoint, the port's torch file) of one draw of
    the direct-features MMBT."""
    from mmf_tpu.utils.checkpoint import _checkpointer

    out = tmp_path_factory.mktemp("init")
    pair = hm.Pair("mmbt", direct=True)
    jax_file = str(out / "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(pair.variables)})
    port_file = str(out / "init_port.pth")
    torch.save(pair.state_dict(pair.variables), port_file)
    return jax_file, port_file


@pytest.fixture(scope="module")
def runs(layout, initial_weights, tmp_path_factory):
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu_torch.cli.run import run as port_run

    def no_download(*args, **kwargs):
        raise AssertionError("the synthetic layout must count as built")

    jax_file, port_file = initial_weights
    jax_dir = str(tmp_path_factory.mktemp("jax_save"))
    port_dir = str(tmp_path_factory.mktemp("port_save"))
    original = jax_download.download
    jax_download.download = no_download
    try:
        jt = jax_run(_opts(layout, jax_dir, *FEATURES,
                           f"checkpoint.resume_file={jax_file}"))
    finally:
        jax_download.download = original
    pt = port_run(_opts(layout, port_dir, *FEATURES,
                        f"checkpoint.resume_file={port_file}"))
    return {"jax": (jt, jax_dir), "port": (pt, port_dir)}


def _losses(trainer):
    return list(trainer.meter.meters[LOSS_KEY].averaged_value_deque)


def test_losses_match_jax_at_every_update(runs):
    jax_losses = _losses(runs["jax"][0])
    port_losses = _losses(runs["port"][0])
    assert len(jax_losses) == len(port_losses) == UPDATES
    assert all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=LOSS_RTOL)


def test_schedule_steps_reach_both_as_a_number(runs):
    for trainer, _ in runs.values():
        steps = trainer.config["scheduler"]["params"]["num_training_steps"]
        assert steps == UPDATES and not isinstance(steps, str)


def test_val_metrics_match_jax(runs):
    values = {}
    for name, (trainer, _) in runs.items():
        report, meter = trainer.evaluation_loop("val")
        assert report.batch_size == 12
        values[name] = {k: meter.meters[f"val/hateful_memes/{k}"].global_avg
                        for k in ("accuracy", "binary_f1", "roc_auc")}
    for k, v in values["jax"].items():
        assert np.isfinite(values["port"][k])
        assert abs(values["port"][k] - v) <= 1e-4, (k, values)


def _csv_rows(save_dir):
    rows = {}
    for f in sorted(glob.glob(os.path.join(save_dir, "reports", "*.csv"))):
        split = "test" if "_test_" in f else "val"
        with open(f) as fh:
            rows[split] = list(csv.DictReader(fh))
    return rows


def test_csv_predictions_match_jax(runs):
    jax_rows, port_rows = (_csv_rows(runs[k][1]) for k in ("jax", "port"))
    assert set(port_rows) == set(jax_rows) == {"val", "test"}
    for split, n in (("val", 12), ("test", 6)):
        assert len(port_rows[split]) == len(jax_rows[split]) == n
        for got, want in zip(port_rows[split], jax_rows[split]):
            assert list(got) == ["id", "proba", "label"]
            assert (got["id"], got["label"]) == (want["id"], want["label"])
            assert abs(float(got["proba"]) - float(want["proba"])) <= 1e-4


def test_run_folders_hold_the_same_files(runs):
    def names(save_dir):
        out = set()
        for entry in os.listdir(save_dir):
            out.add(entry)
            if entry in ("logs", "models", "reports"):
                out.update(f"{entry}/{f}" for f in
                           os.listdir(os.path.join(save_dir, entry)))
        return {re.sub(r"\d{4}[-_]\d\d[-_]\d\dT\d\d[:_]\d\d[:_]\d\d",
                       "<time>", n) for n in out}

    port_names, jax_names = names(runs["port"][1]), names(runs["jax"][1])
    assert "mmbt_final.pth" in port_names
    assert port_names == jax_names


@pytest.fixture(scope="module")
def image_run(layout, tmp_path_factory):
    from mmf_tpu_torch.cli.run import run as port_run

    save_dir = str(tmp_path_factory.mktemp("port_images"))
    # the final model only: a ResNet-152 checkpoint with its optimizer
    # state takes 0.7 GB
    return port_run(_opts(layout, save_dir,
                          "training.checkpoint_interval=1000")), save_dir


def test_raw_image_run_trains_evaluates_and_predicts(image_run):
    trainer, save_dir = image_run
    losses = _losses(trainer)
    assert len(losses) == UPDATES and all(np.isfinite(losses))
    state = trainer.model.state_dict()
    # the run ends on its best evaluation's weights (every 2 updates)
    assert int(state["ResNet152ImageEncoder_0.model.bn1"
                     ".num_batches_tracked"]) in (2, UPDATES)
    assert not torch.equal(state["ResNet152ImageEncoder_0.model.bn1"
                                 ".running_var"], torch.ones(64))
    report, meter = trainer.evaluation_loop("val")
    assert report.batch_size == 12
    for k in ("accuracy", "binary_f1", "roc_auc"):
        assert np.isfinite(meter.meters[f"val/hateful_memes/{k}"].global_avg)
    rows = _csv_rows(save_dir)
    assert {k: len(v) for k, v in rows.items()} == {"val": 12, "test": 6}
    for row in rows["test"]:
        assert list(row) == ["id", "proba", "label"]
        assert 0.0 <= float(row["proba"]) <= 1.0 and row["label"] in "01"
    stopping = trainer.early_stop_callback.early_stopping
    assert stopping.monitored_metric == "val/hateful_memes/roc_auc"
    assert not stopping.minimize and np.isfinite(
        stopping.best_monitored_value)
