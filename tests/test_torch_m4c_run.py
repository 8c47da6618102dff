"""``mmf_run`` on TextVQA with M4C: ``projects/m4c/configs/textvqa/
defaults.yaml`` with ``flagship.TEXTVQA_M4C_OVERRIDES`` (the OCR
features' LMDB), a small M4C (TextBert 2 x 32, MMT 2 x 32, the fc7
layers at their real 2048, f32, every dropout rate 0 through the config
keys), batch 8 (JAX's CPU mesh has 8 devices), trained 4 updates
(Adam with the lr multipliers, multi-step with warmup), evaluated on
``textvqa_accuracy`` with the greedy decode, and predicting the val and
test answers as json, on the synthetic layout
(``tests/torch_textvqa_layout.py``: two LMDBs of 2048-wide features
written by the port's core, seeded imdb files, a 60-word answer
vocabulary; the fasttext stand-in installed in both packages).

Against JAX's ``mmf_run``, both in the process, on the same layout and
initial weights: the losses at each update within 2e-4 relative, the
val loss within 2e-4 and ``textvqa_accuracy`` within 1e-6, the
prediction files' rows equal (the decoded answers, their sources, the
ids), and the run folders' file names equal. JAX's ``textvqa_accuracy``
indexes the packed byte arrays of a real batch and raises (ROADMAP
C.8): its ``calculate`` runs here behind a shim that unpacks
``context_tokens`` and ``answers`` first, as the reference's metric and
the port's do.
"""

import glob
import json
import logging
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import registries_restored, tree_map
from tests.torch_textvqa_layout import (
    FastTextStandIn,
    layout_opts,
    write_layout,
)

torch.set_num_threads(2)  # several test workers share the host

UPDATES = 4
ANSWERS = 60
LOSS_RTOL = 2e-4
LOSS_KEY = "train/textvqa/m4c_decoding_bce_with_mask"
M = "model_config.m4c"
SMALL = [f"{M}.{s}.{k}={v}" for s in ("text_bert", "mmt") for k, v in (
    ("num_hidden_layers", 2), ("hidden_size", 32), ("num_attention_heads", 4),
    ("hidden_dropout_prob", 0.0), ("attention_probs_dropout_prob", 0.0))] + [
    f"{M}.text_bert.vocab_size=200", f"{M}.obj.dropout_prob=0.0",
    f"{M}.ocr.dropout_prob=0.0", f"{M}.classifier.ocr_ptr_net.hidden_size=32",
    f"{M}.classifier.ocr_ptr_net.query_key_size=32"]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("textvqa_run"))
    write_layout(root, n_train=16, n_val=8, n_test=8, n_images=10,
                 max_obj=10, max_ocr=8, num_answers=ANSWERS,
                 vocab_size=200, seed=2)
    return root


def _unpacking(calculate):
    from mmf_tpu.utils.distributed import byte_tensor_to_object

    def wrapped(self, sample_list, model_output, *args, **kwargs):
        sample_list = dict(sample_list)
        for key in ("context_tokens", "answers"):
            sample_list[key] = [byte_tensor_to_object(np.asarray(t))
                                for t in sample_list[key]]
        return calculate(self, sample_list, model_output, *args, **kwargs)

    return wrapped


@pytest.fixture(scope="module", autouse=True)
def _restore_global_state():
    """Both CLIs install logging handlers and fill their registries: the
    runs start from empty registries and everything is put back after
    the module; the fasttext stand-in in both packages."""
    import mmf_tpu.datasets.processors.processors as JP
    import mmf_tpu.modules.metrics as JM
    import mmf_tpu_torch.datasets.processors.processors as PP

    def stand_in(self, model_file):
        if getattr(self, "model", None) is None:  # JAX calls it each time
            self.model = FastTextStandIn()
        self._is_model_loaded = True

    loggers = [logging.getLogger(n) for n in ("mmf_tpu", "mmf_tpu_torch",
                                               "py.warnings")]
    saved = [(lg, list(lg.handlers), lg.level, lg.propagate)
             for lg in loggers]
    with registries_restored(empty=True), warnings.catch_warnings(), \
            pytest.MonkeyPatch.context() as mp:
        for module in (JP, PP):
            mp.setattr(module.FastTextProcessor, "_load_fasttext_model",
                       stand_in)
        mp.setattr(JM.TextVQAAccuracy, "calculate",
                   _unpacking(JM.TextVQAAccuracy.calculate))
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
    from mmf_tpu_torch.utils.flagship import TEXTVQA_M4C_OVERRIDES

    return [
        "config=projects/m4c/configs/textvqa/defaults.yaml", "model=m4c",
        "dataset=textvqa", "training.device=cpu", f"env.save_dir={save_dir}",
        "training.batch_size=8", f"training.max_updates={UPDATES}",
        "training.evaluation_interval=2", "training.checkpoint_interval=2",
        "training.log_interval=1", "training.num_workers=0",
        "training.seed=1", "optimizer.params.lr=1e-3",
        "scheduler.params.warmup_iterations=2",
        "scheduler.params.lr_steps=[3]",
        "run_type=train_val_inference", "evaluation.predict=true",
    ] + SMALL + TEXTVQA_M4C_OVERRIDES + layout_opts(layout) + list(extra)


@pytest.fixture(scope="module")
def initial_weights(tmp_path_factory):
    """(JAX's native checkpoint, the port's torch file) of one JAX init
    of the run's M4C."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu.utils.env import setup_imports
    from mmf_tpu_torch.utils.flagship import textvqa_m4c_batch

    setup_imports()
    out = tmp_path_factory.mktemp("init")
    config = Configuration(_opts("/nonexistent", str(out))).get_config()
    mc = config["model_config"]["m4c"]
    with registries_restored():
        jreg.register("textvqa_num_final_outputs", ANSWERS + 50)
        jm = jreg.get_model_class("m4c")(config=mc)
        batch = tree_map(jnp.asarray, textvqa_m4c_batch(
            2, text_bert_vocab=200))
        variables = jax.jit(lambda b: jm.init(jax.random.PRNGKey(3), b,
                                              False))(batch)
    variables = jax.device_get(variables)
    jax_file = str(out / "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = str(out / "init_port.pth")
    torch.save(params_from_jax(variables["params"]), port_file)
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
        jt = jax_run(_opts(layout, jax_dir,
                           f"checkpoint.resume_file={jax_file}"))
    finally:
        jax_download.download = original
    pt = port_run(_opts(layout, port_dir,
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


def test_val_loss_and_textvqa_accuracy_match_jax(runs):
    values = {}
    for name, (trainer, _) in runs.items():
        report, meter = trainer.evaluation_loop("val")
        assert report.batch_size == 8
        values[name] = {
            k: meter.meters[f"val/textvqa/{k}"].global_avg
            for k in ("m4c_decoding_bce_with_mask", "textvqa_accuracy")}
        assert tuple(report["scores"].shape) == (8, 12, ANSWERS + 50)
    want, got = values["jax"], values["port"]
    assert np.isfinite(got["m4c_decoding_bce_with_mask"])
    assert abs(got["m4c_decoding_bce_with_mask"]
               - want["m4c_decoding_bce_with_mask"]) <= LOSS_RTOL * abs(
        want["m4c_decoding_bce_with_mask"])
    assert abs(got["textvqa_accuracy"] - want["textvqa_accuracy"]) <= 1e-6
    stopping = runs["port"][0].early_stop_callback.early_stopping
    assert stopping.monitored_metric == "val/textvqa/textvqa_accuracy"
    assert not stopping.minimize


def _predictions(save_dir):
    rows = {}
    for f in sorted(glob.glob(os.path.join(save_dir, "reports", "*.json"))):
        split = "test" if "_test_" in f else "val"
        with open(f) as fh:
            rows[split] = json.load(fh)
    return rows


def test_predictions_match_jax(runs):
    jax_rows, port_rows = (_predictions(runs[k][1]) for k in ("jax", "port"))
    assert set(port_rows) == set(jax_rows) == {"val", "test"}
    for split in ("val", "test"):
        assert len(port_rows[split]) == 8
        assert port_rows[split] == jax_rows[split]
        for row in port_rows[split]:
            assert set(row) == {"question_id", "image_id", "answer",
                                "pred_source"}


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
    assert "m4c_final.pth" in port_names
    assert port_names == jax_names
