"""``mmf_run`` on the rest of the M4C family, against JAX's ``mmf_run``:
M4C on ST-VQA (``projects/m4c/configs/stvqa/defaults.yaml``: ANLS and
exact-match accuracy), on OCR-VQA (``ocrvqa/defaults.yaml``: accuracy)
and jointly on TextVQA and ST-VQA (``textvqa/joint_with_stvqa.yaml``,
``multitasking: size_proportional``), each with its
``flagship.M4C_FAMILY_OVERRIDES`` (the OCR features' LMDB, in JAX too);
and the M4C captioner on TextCaps
(``projects/m4c_captioner/configs/m4c_captioner/textcaps/
defaults.yaml``: BLEU-4, and one answer a caption for its ``m4c_answer``
processor, ROADMAP C.4).

A small model (TextBert 2 x 32, MMT 2 x 32, the fc7 layers at their real
2048, f32, every dropout rate 0 through the config keys), batch 8 (JAX's
CPU mesh has 8 devices), trained 4 updates (Adam with the lr multipliers,
multi-step with warmup), evaluated with the greedy decode and predicting
the val and test splits as json, on the synthetic layouts
(``tests/torch_textvqa_layout.py``; ST-VQA's vocabulary holds
TextVQA's answers in another order, as the real files differ). Both CLIs
in the process, on the same layout and initial weights (one JAX init,
carried across by ``params_from_jax``):

- the losses at every update within 1e-6 relative (each dataset's meter
  in the joint run: both packages draw the same datasets);
- the val loss within 1e-6 relative, each metric within 1e-6;
- the prediction files' rows equal (the decoded answers or captions,
  their sources, the ids) and the run folders' file names equal.

JAX's M4C-family metrics index the packed byte arrays of a real batch
and raise (ROADMAP C.8): their ``calculate`` runs here behind a shim that
unpacks ``context_tokens`` and the ground truths first, as the
reference's metrics and the port's do.
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
LOSS_RTOL = 1e-6
METRICS = {"textvqa": ["textvqa_accuracy"],
           "stvqa": ["stvqa_anls", "stvqa_accuracy"],
           "ocrvqa": ["ocrvqa_accuracy"],
           "joint": ["textvqa_accuracy"],
           "textcaps": ["textcaps_bleu4"]}
LAYOUTS = {"textvqa": ("textvqa",), "stvqa": ("stvqa",),
           "ocrvqa": ("ocrvqa",),
           "joint": ("textvqa", "stvqa"), "textcaps": ("textcaps",)}


def small(model: str):
    m = f"model_config.{model}"
    return [f"{m}.{s}.{k}={v}" for s in ("text_bert", "mmt") for k, v in (
        ("num_hidden_layers", 2), ("hidden_size", 32),
        ("num_attention_heads", 4), ("hidden_dropout_prob", 0.0),
        ("attention_probs_dropout_prob", 0.0))] + [
        f"{m}.text_bert.vocab_size=200", f"{m}.obj.dropout_prob=0.0",
        f"{m}.ocr.dropout_prob=0.0",
        f"{m}.classifier.ocr_ptr_net.hidden_size=32",
        f"{m}.classifier.ocr_ptr_net.query_key_size=32"]


def write_layouts(root: str, key: str, seed: int = 2):
    for i, dataset in enumerate(LAYOUTS[key]):
        write_layout(root, n_train=16, n_val=8, n_test=8, n_images=10,
                     max_obj=10, max_ocr=8, num_answers=ANSWERS,
                     vocab_size=200, seed=seed + i, dataset=dataset)


def _unpacking(calculate):
    from mmf_tpu.utils.distributed import byte_tensor_to_object

    def wrapped(self, sample_list, model_output, *args, **kwargs):
        sample_list = dict(sample_list)
        for key in ("context_tokens", self.gt_key):
            sample_list[key] = [byte_tensor_to_object(np.asarray(t))
                                for t in sample_list[key]]
        return calculate(self, sample_list, model_output, *args, **kwargs)

    return wrapped


@pytest.fixture(scope="module", autouse=True)
def _restore_global_state():
    """Both CLIs install logging handlers and fill their registries: the
    runs start from empty registries and everything is put back after
    the module; the fasttext stand-in in both packages; JAX's M4C-family
    metrics behind the unpacking shim (C.8)."""
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
        # the subclasses inherit TextVQAAccuracy.calculate
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


def run_opts(key, layout, save_dir, *extra):
    from mmf_tpu_torch.utils.flagship import (
        M4C_FAMILY,
        M4C_FAMILY_OVERRIDES,
    )

    path, datasets, model = M4C_FAMILY[key]
    return [
        f"config={path}", f"model={model}", f"datasets={datasets}",
        "training.device=cpu", f"env.save_dir={save_dir}",
        "training.batch_size=8", f"training.max_updates={UPDATES}",
        # one validation and one checkpoint, at the end: each checkpoint
        # of the small model with its optimizer state is ~100 MB
        f"training.evaluation_interval={UPDATES}",
        f"training.checkpoint_interval={UPDATES}",
        "training.log_interval=1", "training.num_workers=0",
        "training.seed=1", "optimizer.params.lr=1e-3",
        "scheduler.params.warmup_iterations=2",
        "scheduler.params.lr_steps=[3]",
        "run_type=train_val_inference", "evaluation.predict=true",
    ] + small(model) + M4C_FAMILY_OVERRIDES[key] + [
        o for dataset in LAYOUTS[key] for o in layout_opts(layout, dataset)
    ] + list(extra)


def initial_weights(key, out):
    """(JAX's native checkpoint, the port's torch file) of one JAX init
    of the run's model under ``out``."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu.utils.env import setup_imports
    from mmf_tpu_torch.utils.flagship import M4C_FAMILY, textvqa_m4c_batch

    setup_imports()
    _, datasets, model = M4C_FAMILY[key]
    config = Configuration(run_opts(key, "/nonexistent", str(out))
                           ).get_config()
    mc = config["model_config"][model]
    with registries_restored():
        jreg.register("config", config)
        jreg.register(f"{datasets.split(',')[0]}_num_final_outputs",
                      ANSWERS + 50)
        jm = jreg.get_model_class(model)(config=mc)
        batch = tree_map(jnp.asarray, textvqa_m4c_batch(
            2, text_bert_vocab=200))
        variables = jax.jit(lambda b: jm.init(jax.random.PRNGKey(3), b,
                                              False))(batch)
    variables = jax.device_get(variables)
    jax_file = os.path.join(str(out), "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = os.path.join(str(out), "init_port.pth")
    torch.save(params_from_jax(variables["params"]), port_file)
    return jax_file, port_file


def _clear_processors():
    """Both packages' registries cache a dataset's processors under its
    name, over a layout of their own: each config's runs build theirs."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry as preg

    for reg in (jreg, preg):
        state = reg.mapping["state"]
        for name in [k for k in state if k.endswith("_processor")
                     or k.endswith("_num_final_outputs")
                     or k.endswith("_text_vocab_size")]:
            del state[name]


@pytest.fixture(scope="module", params=["stvqa", "ocrvqa", "joint",
                                        "textcaps"])
def runs(request, tmp_path_factory):
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu_torch.cli.run import run as port_run

    def no_download(*args, **kwargs):
        raise AssertionError("the synthetic layout must count as built")

    key = request.param
    layout = str(tmp_path_factory.mktemp(f"{key}_layout"))
    write_layouts(layout, key)
    jax_file, port_file = initial_weights(
        key, tmp_path_factory.mktemp(f"{key}_init"))
    jax_dir = str(tmp_path_factory.mktemp(f"{key}_jax_save"))
    port_dir = str(tmp_path_factory.mktemp(f"{key}_port_save"))
    original = jax_download.download
    jax_download.download = no_download
    _clear_processors()
    try:
        jt = jax_run(run_opts(key, layout, jax_dir,
                              f"checkpoint.resume_file={jax_file}"))
    finally:
        jax_download.download = original
    pt = port_run(run_opts(key, layout, port_dir,
                           f"checkpoint.resume_file={port_file}"))
    yield {"key": key, "jax": (jt, jax_dir), "port": (pt, port_dir),
           "layout": layout}
    _clear_processors()


def _loss_meters(trainer):
    return {k: list(m.averaged_value_deque)
            for k, m in trainer.meter.meters.items()
            if k.startswith("train/") and k.endswith(
                "m4c_decoding_bce_with_mask")}


def test_losses_match_jax_at_every_update(runs):
    jax_losses = _loss_meters(runs["jax"][0])
    port_losses = _loss_meters(runs["port"][0])
    assert set(port_losses) == set(jax_losses)
    datasets = LAYOUTS[runs["key"]]
    assert set(port_losses) == {
        f"train/{d}/m4c_decoding_bce_with_mask" for d in datasets}
    assert sum(len(v) for v in port_losses.values()) == UPDATES
    for name, want in jax_losses.items():
        got = port_losses[name]
        assert len(got) == len(want) and all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=name)


def test_val_loss_and_metrics_match_jax(runs):
    key = runs["key"]
    values = {}
    for name in ("jax", "port"):
        trainer = runs[name][0]
        np.random.seed(0)  # m4c_answer draws each target's spelling
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # nltk's zero-match warning
            report, meter = trainer.evaluation_loop("val")
        assert tuple(report["scores"].shape)[1:] == (12, ANSWERS + 50)
        values[name] = {k: m.global_avg for k, m in meter.meters.items()
                        if k.startswith("val/")}
    want, got = values["jax"], values["port"]
    assert set(got) == set(want)
    for dataset in LAYOUTS[key]:
        assert f"val/{dataset}/m4c_decoding_bce_with_mask" in got
    for metric in METRICS[key]:
        # the metrics score the combined report of every dataset, under
        # the name of the dataset of the last batch (ROADMAP C.4)
        named = [k for k in got if k.endswith(f"/{metric}")]
        assert len(named) == 1 and named[0].split("/")[1] in LAYOUTS[key]
    for name, value in want.items():
        assert np.isfinite(got[name]), name
        tol = (LOSS_RTOL * abs(value) if name.endswith(
            ("_with_mask", "total_loss")) else 1e-6)
        assert abs(got[name] - value) <= tol, (name, got[name], value)
    stopping = runs["port"][0].early_stop_callback.early_stopping
    if key == "joint":
        assert stopping.monitored_metric == "val/total_loss"
        assert stopping.minimize
    else:
        first = LAYOUTS[key][0]
        assert stopping.monitored_metric == f"val/{first}/{METRICS[key][0]}"
        assert not stopping.minimize


def _predictions(save_dir):
    rows = {}
    for f in sorted(glob.glob(os.path.join(save_dir, "reports", "*.json"))):
        name = os.path.basename(f)
        dataset = name.split("_")[0]
        split = "test" if "_test_" in name else "val"
        with open(f) as fh:
            rows[(dataset, split)] = json.load(fh)
    return rows


def test_predictions_match_jax(runs):
    jax_rows, port_rows = (_predictions(runs[k][1]) for k in ("jax", "port"))
    assert set(port_rows) == set(jax_rows) == {
        (d, s) for d in LAYOUTS[runs["key"]] for s in ("val", "test")}
    fields = ({"caption_id", "image_id", "caption", "pred_source"}
              if runs["key"] == "textcaps" else
              {"question_id", "image_id", "answer", "pred_source"})
    for name, rows in jax_rows.items():
        # each dataset's file holds the rows of every dataset's batches:
        # the prediction loop runs the one multi-dataset loader for each
        # dataset's report, in JAX too (ROADMAP C.4)
        assert len(port_rows[name]) == 8 * len(LAYOUTS[runs["key"]])
        assert port_rows[name] == rows, name
        for row in port_rows[name]:
            assert set(row) == fields


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
    model = "m4c_captioner" if runs["key"] == "textcaps" else "m4c"
    assert f"{model}_final.pth" in port_names
    assert port_names == jax_names
