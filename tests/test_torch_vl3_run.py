"""``mmf_run`` of UNITER, LXMERT and VinVL on the CPU, against JAX's
``mmf_run``, on the synthetic VQA2 and COCO layout
(``tests/torch_vqa2_layout.py`` with full boxes, class probabilities,
object labels, COCO's imdb files and VinVL's label map): the five
configs of ``flagship.VL3`` with their ``VL3_OVERRIDES`` (in JAX too,
ROADMAP C.4), and VisualBERT's ``masked_coco/pretrain.yaml`` now that the
``masked_coco`` builder exists (its quoted ``num_training_steps``
given as a number in both, C.3).

Small models (2 layers, LXMERT 2/1/1, 64 wide, 4 heads), f32, every
dropout rate 0 (the trunks' attention-probability rate, which no config
key reaches, through ``TransformerConfig`` in both packages), batch 8
(JAX's CPU mesh has 8 devices), 2 updates, from one JAX init carried
across by ``params_from_jax``. Both CLIs in the process:

- the losses at every update within 1e-6 relative;
- UNITER's pretraining tasks, drawn an update from Python's ``random``
  after the batch's own draws, the same sequence;
- the val losses within 1e-5 relative (after the updates) and the
  metrics equal;
- the prediction rows equal (VinVL's are empty, as in JAX);
- ``mmf_serve`` (``device=cpu``) answers from each finetuned folder as
  an in-memory engine on the run's weights does.
"""

import glob
import json
import logging
import os
import random
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import jit_init, registries_restored, tree_map
from tests.torch_vqa2_layout import LABEL_MAP, layout_opts, write_layout

torch.set_num_threads(2)  # several test workers share the host

H, V, DIM, ANSWERS, CLS, REGIONS, SEQ = 64, 200, 16, 6, 11, 10, 16
UPDATES, B = 2, 8
LOSS_RTOL = 1e-6
# the val losses come after the updates, whose f32 noise they carry
VAL_LOSS_RTOL = 1e-5
SMALL = {
    "uniter": {"hidden_size": H, "num_hidden_layers": 2,
               "num_attention_heads": 4, "intermediate_size": 2 * H,
               "vocab_size": V, "img_dim": DIM,
               "heads.vqa2.in_dim": H, "heads.vqa2.hidden_size": 2 * H,
               "heads.vqa2.num_labels": ANSWERS,
               "heads.vqa2.hidden_dropout_prob": 0.0},
    "lxmert": {"hidden_size": H, "num_attention_heads": 4,
               "intermediate_size": 2 * H, "vocab_size": V, "l_layers": 2,
               "r_layers": 1, "x_layers": 1, "visual_feat_dim": DIM,
               "num_labels": ANSWERS, "hidden_dropout_prob": 0.0},
    "vinvl": {"hidden_size": H, "num_hidden_layers": 2,
              "num_attention_heads": 4, "intermediate_size": 2 * H,
              "vocab_size": V, "num_labels": ANSWERS,
              "hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0},
    "visual_bert": {"hidden_size": H, "num_hidden_layers": 2,
                    "num_attention_heads": 4, "intermediate_size": 2 * H,
                    "vocab_size": V, "visual_embedding_dim": DIM,
                    "hidden_dropout_prob": 0.0,
                    "attention_probs_dropout_prob": 0.0,
                    "dtype": "float32"},  # bf16 in the YAML
}
UNITER_HEADS = {f"heads.{t}.hidden_size": H
                for t in ("mlm", "itm", "mrc", "mrfr")}
UNITER_HEADS["heads.mlm.vocab_size"] = V
VB_MASKED_COCO = ("projects/visual_bert/configs/masked_coco/pretrain.yaml",
                  "masked_coco", "visual_bert")
KEYS = ["uniter_vqa2", "uniter_masked_coco", "lxmert_vqa2",
        "lxmert_pretrain", "vinvl_vqa2", "visual_bert_masked_coco"]
FINETUNED = ("uniter_vqa2", "lxmert_vqa2", "vinvl_vqa2")


def _spec(key):
    from mmf_tpu_torch.utils.flagship import VL3, VL3_OVERRIDES

    if key == "visual_bert_masked_coco":
        return VB_MASKED_COCO + (
            ["scheduler.params.num_training_steps=11000"],)
    return VL3[key] + (VL3_OVERRIDES[key],)


def run_opts(key, root, save_dir, *extra):
    config, dataset, model = _spec(key)[:3]
    vocab = os.path.join(root, "vocab.txt")
    opts = [
        f"config={config}", f"model={model}", f"dataset={dataset}",
        "training.device=cpu", f"env.save_dir={save_dir}",
        f"training.batch_size={B}", f"training.max_updates={UPDATES}",
        "training.max_epochs=null",
        f"training.evaluation_interval={UPDATES}",
        f"training.checkpoint_interval={UPDATES}",
        "training.log_interval=1", "training.num_workers=0",
        "training.seed=4", "scheduler.params.num_warmup_steps=1",
    ] + _spec(key)[3]
    if key in FINETUNED:
        opts += ["run_type=train_val_inference", "evaluation.predict=true"]
        opts += layout_opts(root, "vqa2") + [
            f"dataset_config.vqa2.max_features={REGIONS}"]
        if key == "vinvl_vqa2":
            opts += [f"dataset_config.vinvl.processors.text_processor.params."
                     f"tokenizer_config.params.vocab_file={vocab}",
                     "dataset_config.vinvl.processors.text_processor.params."
                     "max_seq_length=24"]
        else:
            opts.append("dataset_config.vqa2.processors.text_processor."
                        f"params.max_seq_length={SEQ}")
    else:
        opts.append("run_type=train")
        opts += layout_opts(root, dataset, "masked_token_processor",
                            train_files=2 if key == "lxmert_pretrain" else 1)
        opts.append(f"dataset_config.{dataset}.max_features={REGIONS}")
        if key == "lxmert_pretrain":
            opts.append(f"dataset_config.{dataset}.processors.text_processor"
                        f".params.tokenizer_config.params.vocab_file={vocab}")
        else:
            opts.append(f"dataset_config.{dataset}.processors."
                        f"masked_token_processor.params.max_seq_length={SEQ}")
    small = dict(SMALL[model], **(UNITER_HEADS if key == "uniter_masked_coco"
                                  else {}))
    return opts + [f"model_config.{model}.{k}={v}" for k, v in small.items()
                   ] + list(extra)


def _init_batch():
    rng = np.random.RandomState(5)
    probs = rng.rand(2, REGIONS, CLS).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return {
        "input_ids": rng.randint(5, V, (2, SEQ)).astype(np.int64),
        "input_mask": np.ones((2, SEQ), np.int64),
        "segment_ids": np.zeros((2, SEQ), np.int64),
        "lm_label_ids": rng.randint(5, V, (2, SEQ)).astype(np.int64),
        "is_correct": np.ones((2,), np.int64),
        "image_feature_0": rng.randn(2, REGIONS, DIM).astype(np.float32),
        "image_info_0": {"bbox": rng.rand(2, REGIONS, 5).astype(np.float32),
                         "cls_prob": probs,
                         "max_features": np.full((2,), REGIONS, np.int64)},
        "image_labels": np.ones((2, REGIONS), np.int64),
    }


def initial_weights(key, root, out):
    """(JAX's native checkpoint, the port's torch file) of one JAX init
    of the run's model."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu.utils.env import setup_imports

    setup_imports()
    _, dataset, model = _spec(key)[:3]
    config = Configuration(run_opts(key, root, str(out))).get_config()
    jm = jreg.get_model_class(model)(config=config["model_config"][model])
    batch = dict(tree_map(jnp.asarray, _init_batch()),
                 dataset_name=dataset, dataset_type="train")
    variables = jax.device_get(jit_init(jm, jax.random.PRNGKey(3), batch,
                                        False))
    jax_file = os.path.join(str(out), "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = os.path.join(str(out), "init_port.pth")
    torch.save(params_from_jax(variables["params"]), port_file)
    return jax_file, port_file


def _zero_rates(cls):
    init = cls.__init__

    def zero(self, *args, **kwargs):
        init(self, *args, **kwargs)
        object.__setattr__(self, "hidden_dropout_prob", 0.0)
        object.__setattr__(self, "attention_probs_dropout_prob", 0.0)

    return zero


@pytest.fixture(scope="module", autouse=True)
def _restore_global_state():
    """Both CLIs install logging handlers and fill their registries: the
    runs start from empty registries and everything is put back after
    the module. Every ``TransformerConfig`` of both packages is built at
    dropout 0: no config key reaches the trunks' attention rate."""
    from mmf_tpu.modules.transformer import TransformerConfig as JConfig
    from mmf_tpu_torch.modules.transformer import TransformerConfig

    loggers = [logging.getLogger(n) for n in ("mmf_tpu", "mmf_tpu_torch",
                                               "py.warnings")]
    saved = [(lg, list(lg.handlers), lg.level, lg.propagate)
             for lg in loggers]
    with registries_restored(empty=True), warnings.catch_warnings(), \
            pytest.MonkeyPatch.context() as mp:
        for cls in (JConfig, TransformerConfig):
            mp.setattr(cls, "__init__", _zero_rates(cls))
        yield
    for lg, handlers, level, propagate in saved:
        for h in lg.handlers:
            if h not in handlers:
                h.close()
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate
    logging.captureWarnings(False)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vl3_layout"))
    # 30 images: COCO's val split holds 8, a whole batch (JAX's mesh pads
    # a short one)
    write_layout(root, n_train=16, n_val=8, n_test=8, n_images=30,
                 regions=REGIONS, feature_dim=DIM, num_answers=ANSWERS,
                 vocab_size=V, seed=3, full_boxes=True, cls_prob_width=CLS,
                 coco=True, object_labels=True)
    return root


def _clear_processors():
    """A dataset takes the processors its registry holds under its name:
    each config's runs build theirs."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry as preg

    for reg in (jreg, preg):
        state = reg.mapping["state"]
        for name in [k for k in state if k.endswith("_processor")
                     or k.endswith("_num_final_outputs")
                     or k.endswith("_text_vocab_size")]:
            del state[name]


@pytest.fixture(scope="module")
def runs(layout, tmp_path_factory):
    """Every key's JAX and port runs, and the UNITER tasks each drew."""
    import mmf_tpu.models.uniter as JU
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu_torch.cli.run import run as port_run
    from mmf_tpu_torch.models.uniter import UNITER

    tasks = {"jax": [], "port": []}

    def recording(cls, side):
        draw = cls.get_step_meta

        def get_step_meta(self):
            meta = draw(self)
            tasks[side].append(meta.get("task"))
            return meta

        return get_step_meta

    def no_download(*args, **kwargs):
        raise AssertionError("the synthetic layout must count as built")

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JU.UNITER, "get_step_meta", recording(JU.UNITER, "jax"))
        mp.setattr(UNITER, "get_step_meta", recording(UNITER, "port"))
        mp.setattr(jax_download, "download", no_download)
        for key in KEYS:
            init = tmp_path_factory.mktemp(f"{key}_init")
            jax_file, port_file = initial_weights(key, layout, init)
            jax_dir = str(tmp_path_factory.mktemp(f"{key}_jax"))
            port_dir = str(tmp_path_factory.mktemp(f"{key}_port"))
            _clear_processors()
            for side in tasks.values():
                side.clear()
            jt = jax_run(run_opts(key, layout, jax_dir,
                                  f"checkpoint.resume_file={jax_file}"))
            _clear_processors()
            pt = port_run(run_opts(key, layout, port_dir,
                                   f"checkpoint.resume_file={port_file}"))
            out[key] = {"jax": (jt, jax_dir), "port": (pt, port_dir),
                        "tasks": {k: list(v) for k, v in tasks.items()}}
    yield out
    _clear_processors()


def _train_losses(trainer):
    return {k: list(m.averaged_value_deque)
            for k, m in trainer.meter.meters.items()
            if k.startswith("train/") and not k.endswith("total_loss")}


LOSS_NAMES = {
    "uniter_vqa2": {"train/vqa2/logit_bce"},
    "lxmert_vqa2": {"train/vqa2/logit_bce"},
    "lxmert_pretrain": {"train/masked_vqa2/masked_lm_loss",
                        "train/masked_vqa2/matched_loss",
                        "train/masked_vqa2/feat_loss"},
    "vinvl_vqa2": {"train/vinvl/logit_bce"},
    "visual_bert_masked_coco": {"train/masked_coco/masked_lm_loss"},
}


@pytest.mark.parametrize("key", KEYS)
def test_losses_match_jax_at_every_update(runs, key):
    jt, pt = runs[key]["jax"][0], runs[key]["port"][0]
    want, got = _train_losses(jt), _train_losses(pt)
    assert set(got) == set(want)
    if key in LOSS_NAMES:
        assert set(got) == LOSS_NAMES[key]
    for name, values in want.items():
        assert len(got[name]) == len(values) and np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], values, rtol=LOSS_RTOL,
                                   err_msg=name)
    total = [list(t.meter.meters["train/total_loss"].averaged_value_deque)
             for t in (pt, jt)]
    assert len(total[0]) == UPDATES
    np.testing.assert_allclose(total[0], total[1], rtol=LOSS_RTOL)


def test_uniter_draws_the_same_tasks_as_jax(runs):
    """One task an update from Python's ``random`` after the batch's own
    draws (the masked captions and regions), in both packages; each
    update's loss is its task's."""
    tasks = runs["uniter_masked_coco"]["tasks"]
    assert tasks["port"] == tasks["jax"]
    assert len(tasks["port"]) == UPDATES
    assert set(tasks["port"]) <= {"mlm", "itm", "mrc", "mrfr"}
    losses = _train_losses(runs["uniter_masked_coco"]["port"][0])
    assert {k.rsplit("/", 1)[1] for k in losses} == {
        f"{t}_loss" if t != "mlm" else "masked_lm_loss"
        for t in tasks["port"]}


@pytest.mark.parametrize("key", KEYS)
def test_val_losses_and_metrics_match_jax(runs, key):
    values = {}
    for side in ("jax", "port"):
        # the masked datasets draw their masks again: from the same state
        random.seed(0)
        np.random.seed(0)
        report, meter = runs[key][side][0].evaluation_loop("val")
        values[side] = {k: m.global_avg for k, m in meter.meters.items()}
    want, got = values["jax"], values["port"]
    assert set(got) == set(want) and got
    for name, value in want.items():
        assert np.isfinite(got[name]), name
        if "accuracy" in name:
            assert got[name] == value, name
        else:
            np.testing.assert_allclose(got[name], value, rtol=VAL_LOSS_RTOL,
                                       err_msg=name)


def _predictions(save_dir):
    rows = {}
    for f in sorted(glob.glob(os.path.join(save_dir, "reports", "*.json"))):
        split = "test" if "_test_" in os.path.basename(f) else "val"
        with open(f) as fh:
            rows[split] = json.load(fh)
    return rows


@pytest.mark.parametrize("key", FINETUNED)
def test_prediction_rows_match_jax(runs, key):
    want = _predictions(runs[key]["jax"][1])
    got = _predictions(runs[key]["port"][1])
    assert set(got) == set(want) == {"val", "test"}
    assert got == want
    if key == "vinvl_vqa2":
        assert got["test"] == []  # VinVL's dataset formats no rows
    else:
        assert len(got["test"]) == 8
        assert {"question_id", "answer"} <= set(got["test"][0])


@pytest.mark.parametrize("key", FINETUNED)
def test_mmf_serve_answers_from_the_finetuned_checkpoint(runs, key):
    """``mmf_serve`` (``cli/serve.py``, ``device=cpu``) builds the model
    from the run's folder through the registry; a request's ``text`` goes
    through the checkpoint's text processor (VinVL's tokenizer for
    VinVL), its features and boxes come as fields, and the answer equals
    an in-memory engine's on the run's weights (the same plain versions
    on the same inputs)."""
    import urllib.request

    from mmf_tpu_torch.cli import serve as serve_cli
    from mmf_tpu_torch.serving import ServingEngine
    from mmf_tpu_torch.serving.server import default_prepare
    from mmf_tpu_torch.utils import flagship

    pt, port_dir = runs[key]["port"]
    batch = flagship.vilbert_example_batch(1, SEQ, REGIONS, DIM, seed=5)
    request = {"text": "what color is the dog?", "fields": {
        "image_feature_0": batch["image_feature_0"][0].tolist(),
        "image_info_0": {"bbox": batch["image_info_0"]["bbox"][0].tolist()}}}
    server = serve_cli.build_server(serve_cli.parse_opts(
        [f"checkpoint={port_dir}", "port=0", "device=cpu",
         "max_batch_size=4", "max_wait_ms=1"])).start()
    try:
        sample = default_prepare(server.engine, request)
        assert {"input_ids", "input_mask", "image_feature_0"} <= set(sample)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/predict",
            data=json.dumps(request).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            got = np.asarray(json.loads(r.read())["scores"], np.float32)
    finally:
        server.shutdown()
    model = flagship.vl3_model(pt.config, example=batch)
    model.load_state_dict(pt.model.state_dict(), strict=True)
    want = ServingEngine(model, device="cpu").predict(sample)["scores"]
    assert got.shape == (ANSWERS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_layout_label_map_names_the_tags(layout):
    with open(os.path.join(layout, "datasets", LABEL_MAP)) as f:
        label_map = json.load(f)
    assert set(label_map) == {"idx_to_label", "idx_to_attribute"}
    assert "0" not in label_map["idx_to_label"]
