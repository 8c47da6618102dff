"""``mmf_run`` in the port against JAX's, both in the process, on the same
synthetic VQA2 layout and the same initial weights: a 2-layer VisualBERT
(hidden 32, 6 answers, dropout 0, f32) trained 4 updates with the VQA2
VisualBERT config, evaluated and predicting.

- the losses at each update within rtol 2e-4 (``test_torch_train_step``'s
  trajectory bound), the val ``vqa_accuracy`` equal, the prediction rows
  equal, the run folders' file names equal (time stamps aside);
- a resume of the port's run from its update-2 checkpoint continues the
  uninterrupted run's losses;
- without a card and without ``training.device=cpu`` the port raises.

JAX starts from a native checkpoint of its init; the port from the same
weights carried across by ``params_from_jax`` into a torch file.
"""

import glob
import json
import logging
import os
import re
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax

from tests.torch_port_utils import jit_init, registries_restored
from tests.torch_vqa2_layout import layout_opts, write_layout

TINY = {
    "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "intermediate_size": 64,
    "visual_embedding_dim": 16, "max_position_embeddings": 32,
    "num_labels": 6, "dtype": "float32", "hidden_dropout_prob": 0.0,
    "attention_probs_dropout_prob": 0.0,
}
SEQ, REGIONS = 16, 10
UPDATES = 4
# the trajectory bound of tests/test_torch_train_step.py
LOSS_RTOL = 2e-4
LOSS_KEY = "train/vqa2/logit_bce"


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vqa2_layout"))
    write_layout(root, n_train=16, n_val=12, n_test=6, n_images=10,
                 regions=REGIONS, feature_dim=TINY["visual_embedding_dim"],
                 num_answers=TINY["num_labels"],
                 vocab_size=TINY["vocab_size"], seed=0)
    return root


@pytest.fixture(scope="module", autouse=True)
def _restore_global_state():
    """Both CLIs install logging handlers (and stop their loggers'
    propagation) and fill their registries: the runs start from empty
    registries (an earlier file's cached processors would feed them),
    and everything is put back after the module. Module-scoped and
    autouse, so that it wraps the runs."""
    loggers = [logging.getLogger(n) for n in ("mmf_tpu", "mmf_tpu_torch",
                                               "py.warnings")]
    saved = [(lg, list(lg.handlers), lg.level, lg.propagate)
             for lg in loggers]
    with registries_restored(empty=True), warnings.catch_warnings():
        yield
    for lg, handlers, level, propagate in saved:
        for h in lg.handlers:
            if h not in handlers:
                h.close()
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate
    logging.captureWarnings(False)


def _opts(layout, save_dir, *extra):
    return [
        "config=projects/visual_bert/configs/vqa2/defaults.yaml",
        "model=visual_bert", "dataset=vqa2", "training.device=cpu",
        f"env.save_dir={save_dir}", "training.batch_size=8",
        f"training.max_updates={UPDATES}", "training.evaluation_interval=2",
        "training.checkpoint_interval=2", "training.log_interval=1",
        "training.num_workers=0", "training.seed=1",
        "scheduler.params.num_warmup_steps=1",
        "run_type=train_val_inference", "evaluation.predict=true",
        "dataset_config.vqa2.max_features=10",
        "dataset_config.vqa2.processors.text_processor.params."
        f"max_seq_length={SEQ}",
    ] + layout_opts(layout) + [
        f"model_config.visual_bert.{k}={v}" for k, v in TINY.items()
    ] + list(extra)


@pytest.fixture(scope="module")
def initial_weights(tmp_path_factory):
    """(JAX's native checkpoint of an init, the port's torch file of the
    same weights)."""
    import jax.numpy as jnp

    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
    from tests.torch_port_utils import jax_visual_bert

    out = tmp_path_factory.mktemp("init")
    model = jax_visual_bert(dict(TINY))
    rng = np.random.RandomState(0)
    batch = {
        "input_ids": jnp.asarray(rng.randint(0, 64, (2, SEQ))),
        "input_mask": jnp.ones((2, SEQ), jnp.int32),
        "segment_ids": jnp.zeros((2, SEQ), jnp.int32),
        "image_feature_0": jnp.asarray(
            rng.randn(2, REGIONS, TINY["visual_embedding_dim"]),
            jnp.float32),
        "dataset_name": "vqa2", "dataset_type": "train",
    }
    key = jax.random.PRNGKey(3)
    variables = jax.device_get(
        jit_init(model, {"params": key, "dropout": key}, batch, False))
    jax_file = str(out / "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = str(out / "init_port.pth")
    state_dict = params_from_jax(variables["params"],
                                 variables.get("batch_stats"))
    torch.save({k: torch.as_tensor(np.asarray(v))
                for k, v in state_dict.items()}, port_file)
    return jax_file, port_file


def _losses(trainer):
    return list(trainer.meter.meters[LOSS_KEY].averaged_value_deque)


def _predictions(save_dir):
    rows = {}
    for f in sorted(glob.glob(os.path.join(save_dir, "reports", "*.json"))):
        split = "test" if "_test_" in f else "val"
        rows[split] = json.load(open(f))
    return rows


def _file_names(save_dir):
    """The run folder's entries and those of its folders ``logs``,
    ``models`` and ``reports``, time stamps masked (a JAX checkpoint is
    an orbax folder, the port's a file: each is one entry)."""
    names = set()
    for entry in os.listdir(save_dir):
        names.add(entry)
        if entry in ("logs", "models", "reports"):
            names.update(f"{entry}/{f}"
                         for f in os.listdir(os.path.join(save_dir, entry)))
    return {re.sub(r"\d{4}[-_]\d\d[-_]\d\dT\d\d[:_]\d\d[:_]\d\d",
                   "<time>", n) for n in names}


@pytest.fixture(scope="module")
def runs(layout, initial_weights, tmp_path_factory):
    """The JAX run and the port's, on the same layout and weights; the
    JAX package may not reach the network: its download raises."""
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
        with warnings.catch_warnings():
            jt = jax_run(_opts(layout, jax_dir,
                               f"checkpoint.resume_file={jax_file}"))
    finally:
        jax_download.download = original
    with warnings.catch_warnings():
        pt = port_run(_opts(layout, port_dir,
                            f"checkpoint.resume_file={port_file}"))
    return {"jax": (jt, jax_dir), "port": (pt, port_dir)}


def test_losses_match_jax_at_every_update(runs):
    jax_losses = _losses(runs["jax"][0])
    port_losses = _losses(runs["port"][0])
    assert len(jax_losses) == len(port_losses) == UPDATES
    assert all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=LOSS_RTOL)


def test_val_accuracy_and_predictions_match_jax(runs):
    accuracies = {}
    for name, (trainer, _) in runs.items():
        report, meter = trainer.evaluation_loop("val")
        # 12 questions: a full batch and a padded one trimmed to 4
        assert report.batch_size == 12
        accuracies[name] = meter.meters["val/vqa2/vqa_accuracy"].global_avg
    assert 0.0 <= accuracies["port"] <= 1.0
    assert accuracies["port"] == accuracies["jax"]

    jax_rows = _predictions(runs["jax"][1])
    port_rows = _predictions(runs["port"][1])
    assert set(port_rows) == {"val", "test"}
    assert len(port_rows["test"]) == 6 and len(port_rows["val"]) == 12
    assert port_rows == jax_rows


def test_run_folders_hold_the_same_files(runs):
    jax_names = _file_names(runs["jax"][1])
    port_names = _file_names(runs["port"][1])
    for name in ("config.yaml", "current.ckpt", "best.ckpt",
                 "models/model_2.ckpt", "models/model_4.ckpt",
                 "visual_bert_final.pth"):
        assert name in port_names, sorted(port_names)
    assert port_names == jax_names


def test_resume_continues_the_uninterrupted_run(runs, layout,
                                                tmp_path_factory):
    """The update-2 checkpoint ends epoch 1 (16 questions, batch 8), so a
    resume draws epoch 2's batches, as the uninterrupted run did."""
    from mmf_tpu_torch.cli.run import run as port_run

    trainer, port_dir = runs["port"]
    resume_dir = str(tmp_path_factory.mktemp("port_resume"))
    shutil.copyfile(os.path.join(port_dir, "models", "model_2.ckpt"),
                    os.path.join(resume_dir, "current.ckpt"))
    with warnings.catch_warnings():
        resumed = port_run(_opts(layout, resume_dir, "checkpoint.resume=true"))
    np.testing.assert_allclose(_losses(resumed), _losses(trainer)[2:],
                               rtol=1e-6)


def test_no_card_without_device_cpu_raises(layout, tmp_path):
    from mmf_tpu_torch.cli.run import run as port_run

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would take it")
    opts = [o for o in _opts(layout, str(tmp_path))
            if o != "training.device=cpu"]
    with pytest.raises(RuntimeError, match="training.device=cpu"):
        port_run(opts)
