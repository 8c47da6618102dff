"""``mmf_run`` with ViLBERT on the CPU, on the synthetic VQA2 layout
(``tests/torch_vqa2_layout.py`` with full boxes and class probabilities):
a small ViLBERT (the config of ``tests/test_torch_vilbert.py``, dropout
0, f32) from the same initial weights in JAX's CLI and the port's.

- VQA2 finetuning with ``projects/vilbert/configs/vqa2/defaults.yaml``
  and the overrides it needs (``flagship.VILBERT_VQA2_OVERRIDES``): 2
  updates, an evaluation and the prediction reports; the losses within
  rtol 2e-4 (``tests/test_torch_train_step.py``'s trajectory bound), the
  val ``vqa_accuracy`` and the prediction rows equal;
- masked-VQA2 pretraining with ``projects/vilbert/configs/masked_vqa2/
  pretrain.yaml`` (``flagship.VILBERT_MASKED_VQA2_OVERRIDES``): 2
  updates with both losses, each within the same bound of JAX's on the
  same seeded masks, and equal to the port's train step on the batches
  the run took.
"""

import logging
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_vilbert import SMALL
from tests.torch_port_utils import registries_restored
from tests.torch_vqa2_layout import layout_opts, write_layout

SEQ, REGIONS, DIM, ANSWERS, TARGETS = 16, 10, 16, 6, 11
UPDATES = 2
LOSS_RTOL = 2e-4
MODEL = dict(SMALL, num_labels=ANSWERS, vocab_size=64, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0, v_hidden_dropout_prob=0.0,
             v_attention_probs_dropout_prob=0.0, v_feature_size=DIM,
             v_target_size=TARGETS)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vilbert_run_layout"))
    write_layout(root, n_train=16, n_val=8, n_test=4, n_images=6,
                 regions=REGIONS, feature_dim=DIM, num_answers=ANSWERS,
                 vocab_size=MODEL["vocab_size"], seed=3, full_boxes=True,
                 cls_prob_width=TARGETS)
    return root


@pytest.fixture(scope="module", autouse=True)
def _restore_global_state():
    """Both CLIs install logging handlers and fill their registries: the
    runs start from empty registries (an earlier file's cached processors
    would feed them), and everything is put back after the module."""
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


RUNS = {  # name -> (config, dataset, overrides, head, text processor)
    "vqa2": ("projects/vilbert/configs/vqa2/defaults.yaml", "vqa2",
             "VILBERT_VQA2_OVERRIDES", "classification", "text_processor"),
    "masked_vqa2": ("projects/vilbert/configs/masked_vqa2/pretrain.yaml",
                    "masked_vqa2", "VILBERT_MASKED_VQA2_OVERRIDES",
                    "pretraining", "masked_token_processor"),
}


def _opts(name, layout, save_dir, *extra):
    from mmf_tpu_torch.utils import flagship

    config, dataset, overrides, head, text = RUNS[name]
    opts = [
        f"config={config}", "model=vilbert", f"dataset={dataset}",
        "training.device=cpu", f"env.save_dir={save_dir}",
        "training.batch_size=8", f"training.max_updates={UPDATES}",
        "training.evaluation_interval=2", "training.checkpoint_interval=2",
        "training.log_interval=1", "training.num_workers=0",
        "training.seed=1", "scheduler.params.num_warmup_steps=1",
        f"dataset_config.{dataset}.max_features={REGIONS}",
        f"dataset_config.{dataset}.processors.{text}.params."
        f"max_seq_length={SEQ}",
    ] + getattr(flagship, overrides) + layout_opts(layout, dataset, text)
    if name == "vqa2":
        opts += ["run_type=train_val_inference", "evaluation.predict=true",
                 "scheduler.type=warmup_cosine",
                 "scheduler.params.num_training_steps=10",
                 "training.lr_scheduler=true"]
    else:
        opts += ["run_type=train", "scheduler.params.num_training_steps=10"]
    return opts + [f"model_config.vilbert.{k}={v}" for k, v in
                   dict(MODEL, training_head_type=head).items()] + list(extra)


def _initial_weights(head, out):
    """(JAX's native checkpoint of an init, the port's torch file of the
    same weights)."""
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
    from tests.test_torch_vilbert import _batch, _jax_model
    from tests.torch_port_utils import tree_map

    model = _jax_model(dict(MODEL, training_head_type=head))
    batch = dict(tree_map(jnp.asarray, _batch(head=head)),
                 dataset_name="vqa2", dataset_type="train")
    variables = jax.device_get(model.init(jax.random.PRNGKey(3), batch,
                                          False))
    jax_file = str(out / f"init_jax_{head}")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = str(out / f"init_port_{head}.pth")
    torch.save(params_from_jax(variables["params"]), port_file)
    return jax_file, port_file


class _Recorder:
    """Wraps the trainer's train step: the batches it took, on the CPU."""

    def __init__(self, trainer):
        self.batches = []
        self.step = trainer._get_train_step()
        trainer._train_step = self

    def __call__(self, state, batch):
        self.batches.append(dict(batch))
        return self.step(state, batch)


@pytest.fixture(scope="module")
def runs(layout, tmp_path_factory):
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu_torch.cli import run as port_cli
    from mmf_tpu_torch.trainers.mmf_trainer import MMFTrainer

    def no_download(*args, **kwargs):
        raise AssertionError("the synthetic layout must count as built")

    recorders = []
    original_train = MMFTrainer.train

    def recording_train(self):
        recorders.append(_Recorder(self))
        return original_train(self)

    out = {}
    for name, (_, _, _, head, _) in RUNS.items():
        jax_file, port_file = _initial_weights(
            head, tmp_path_factory.mktemp(f"init_{name}"))
        jax_dir = str(tmp_path_factory.mktemp(f"jax_{name}"))
        port_dir = str(tmp_path_factory.mktemp(f"port_{name}"))
        original = jax_download.download
        jax_download.download = no_download
        try:
            jt = jax_run(_opts(name, layout, jax_dir,
                               f"checkpoint.resume_file={jax_file}"))
        finally:
            jax_download.download = original
        MMFTrainer.train = recording_train
        try:
            pt = port_cli.run(_opts(name, layout, port_dir,
                                    f"checkpoint.resume_file={port_file}"))
        finally:
            MMFTrainer.train = original_train
        out[name] = (jt, pt, recorders.pop(), port_file, port_dir)
    return out


def _losses(trainer, key):
    return list(trainer.meter.meters[key].averaged_value_deque)


def test_runs_start_from_empty_registries():
    """A dataset caches its processors in its registry's state
    (``vqa2_text_processor``, ...) and a later dataset of the same name
    reuses them. JAX's VQA2 run here once read its questions through the
    processors an earlier file's VisualBERT run had left in JAX's
    registry (its second loss 5.1469 against the port's 5.0979): the
    module's runs see both registries empty, and find them as they were
    afterwards."""
    from mmf_tpu.common.registry import registry as jax_registry
    from mmf_tpu_torch.common.registry import registry as port_registry

    key, stale = "vqa2_text_processor", object()
    registries = (jax_registry, port_registry)
    for r in registries:
        r.register(key, stale)
    try:
        with registries_restored(empty=True):
            for r in registries:
                assert r.mapping["state"] == {}
                r.register(key, "the run's own")
        for r in registries:
            assert r.get(key, no_warning=True) is stale
    finally:
        for r in registries:
            r.mapping["state"].pop(key, None)


def test_vilbert_vqa2_run_matches_jax(runs):
    jt, pt, _, _, port_dir = runs["vqa2"]
    key = "train/vqa2/logit_bce"
    port_losses = _losses(pt, key)
    assert len(port_losses) == UPDATES and np.isfinite(port_losses).all()
    np.testing.assert_allclose(port_losses, _losses(jt, key), rtol=LOSS_RTOL)
    accuracy = {}
    for name, trainer in (("jax", jt), ("port", pt)):
        report, meter = trainer.evaluation_loop("val")
        assert report.batch_size == 8
        accuracy[name] = meter.meters["val/vqa2/vqa_accuracy"].global_avg
    assert 0.0 <= accuracy["port"] <= 1.0
    assert accuracy["port"] == accuracy["jax"]
    assert pt.model.bert.v_location_embeddings.weight.shape[1] == 5
    assert os.path.exists(os.path.join(port_dir, "vilbert_final.pth"))
    reports = os.listdir(os.path.join(port_dir, "reports"))
    assert any("_test_" in f for f in reports), reports


def test_vilbert_masked_vqa2_run_matches_jax_and_the_train_step(runs):
    from mmf_tpu_torch.utils import flagship

    jt, pt, recorder, port_file, _ = runs["masked_vqa2"]
    keys = ["train/masked_vqa2/masked_lm_loss",
            "train/masked_vqa2/masked_img_loss"]
    for key in keys:
        port_losses = _losses(pt, key)
        assert len(port_losses) == UPDATES and np.isfinite(port_losses).all()
        np.testing.assert_allclose(port_losses, _losses(jt, key),
                                   rtol=LOSS_RTOL, err_msg=key)
    # the trainer adds nothing to the train step on the batches it took
    assert len(recorder.batches) == UPDATES
    cfg = pt.config
    model = flagship.vqa2_vilbert(cfg, example=None)
    model.load_state_dict(torch.load(port_file), strict=True)
    state, step = flagship.masked_vqa2_trainer(
        model, cfg, seed=int(cfg["training"]["seed"]), device="cpu")
    for n, batch in enumerate(recorder.batches):
        state, rep = step(state, batch)
        for key in keys:
            assert float(rep["losses"][key]) == _losses(pt, key)[n], key


def test_mmf_serve_answers_from_the_finetuned_checkpoint(runs):
    """``mmf_serve`` (``cli/serve.py``, ``device=cpu``) builds ViLBERT from
    the VQA2 run's folder through the registry; a request's ``text`` goes
    through the checkpoint's bert_tokenizer, its region features and
    boxes come as fields, and the answer equals an in-memory engine's on
    the run's weights (the same plain versions on the same inputs: atol
    1e-6)."""
    import json
    import urllib.request

    from mmf_tpu_torch.cli import serve as serve_cli
    from mmf_tpu_torch.serving import ServingEngine
    from mmf_tpu_torch.serving.server import default_prepare
    from mmf_tpu_torch.utils import flagship

    _, pt, _, _, port_dir = runs["vqa2"]
    batch = flagship.vilbert_example_batch(1, SEQ, REGIONS, DIM, seed=5)
    info = batch["image_info_0"]
    request = {"text": "what color is the dog?", "fields": {
        "image_feature_0": batch["image_feature_0"][0].tolist(),
        "image_info_0": {"bbox": info["bbox"][0].tolist(),
                         "max_features": int(info["max_features"][0])}}}
    server = serve_cli.build_server(serve_cli.parse_opts(
        [f"checkpoint={port_dir}", "port=0", "device=cpu",
         "max_batch_size=4", "max_wait_ms=1"])).start()
    try:
        sample = default_prepare(server.engine, request)
        assert {"input_ids", "input_mask", "segment_ids", "image_feature_0",
                "image_info_0"} <= set(sample)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/predict",
            data=json.dumps(request).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            got = np.asarray(json.loads(r.read())["scores"], np.float32)
    finally:
        server.shutdown()
    model = flagship.vqa2_vilbert(pt.config)
    model.load_state_dict(pt.model.state_dict(), strict=True)
    want = ServingEngine(model, device="cpu").predict(sample)["scores"]
    assert got.shape == (ANSWERS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
