"""ViLT in the port against the JAX package on the CPU: a small ViLT (2
layers, width 32, 32 px images in patches of 8) initialised in JAX, its
params carried across by ``params_from_jax``, and the same numpy inputs
through both; JAX runs its plain (XLA) attention and LayerNorm, the port
its plain versions. Bars: f32 outputs atol 2e-5, losses rtol 1e-5;
step-0 gradients relative 5e-4 over a floor of 1e-3 of the global
gradient scale; a 4-step AdamW trajectory with losses rtol 2e-4 and
parameters relative 1e-3 (those of ``tests/test_torch_train_step.py``).
Dropout is 0 on both sides where gradients are compared: ViLT's text
embeddings and encoder take ``TransformerConfig``'s rates, which no
config key reaches, so the JAX side's configs are built at rate 0 for
those tests (``jax_no_dropout``)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import cached_init, tree_map

torch.set_num_threads(2)  # several test workers share the host

SMALL = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
         "vocab_size": 100}
IMAGE = {"patch_size": 8, "image_size": [32, 32], "mlp_dim": 64}
META = {"dataset_name": "vqa2", "dataset_type": "train"}
ATOL = 2e-5
B, T, LABELS = 4, 8, 5
MLP = {"type": "mlp", "in_dim": 32, "hidden_size": 48, "num_labels": LABELS,
       "loss": "vqa2_mlp", "pooler_name": "bert_pooler"}
HEADS = {  # name -> the vqa2 heads
    "mlp": [MLP],
    "itm_mlm": [{"type": "itm", "hidden_size": 32},
                {"type": "mlm", "hidden_size": 32, "vocab_size": 100}],
    "mlm_multi_itm": [{"type": "mlm_multi", "hidden_size": 32,
                       "vocab_size": 100},
                      {"type": "itm", "hidden_size": 32}],
    "mlp_itm_mlm": [dict(MLP, hidden_dropout_prob=0.0),
                    {"type": "itm", "hidden_size": 32},
                    {"type": "mlm", "hidden_size": 32, "vocab_size": 100}],
}


def _config(load_yaml, heads):
    mc = load_yaml("configs/models/vilt/defaults.yaml")["model_config"][
        "vilt"]
    mc.update(SMALL)
    mc["image_encoder"]["params"].update(IMAGE)
    mc["heads"] = {"vqa2": heads}
    mc["losses"] = {"vqa2_mlp": "logit_bce"}
    return mc


def _jax_model(heads):
    from mmf_tpu.common.registry import registry
    from mmf_tpu.config.configuration import load_yaml
    from mmf_tpu.utils.env import setup_imports

    setup_imports()
    return registry.get_model_class("vilt")(config=_config(load_yaml, heads))


def _port_model(heads):
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    return registry.get_model_class("vilt")(config=_config(load_yaml, heads))


def _batch(seed=0, no_labels=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 100, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[0, T - 3:] = 0
    ids[0, T - 3:] = 0
    masked = np.where(rng.rand(B, T) < 0.3, 3, ids).astype(np.int32)
    lm = np.where(masked != ids, ids, -1).astype(np.int32)
    lm[:, 1] = ids[:, 1]
    if no_labels:
        lm[:] = -1
    targets = np.zeros((B, LABELS), np.float32)
    targets[np.arange(B), rng.randint(0, LABELS, B)] = 1.0
    segment = np.zeros((B, T), np.int32)
    segment[1, T // 2:] = 1
    return {"input_ids": ids, "input_mask": mask, "segment_ids": segment,
            "input_ids_masked": masked, "lm_label_ids": lm,
            "is_correct": np.array([1, 0, 1, 1], np.int32),
            "image": rng.randn(B, 3, 32, 32).astype(np.float32),
            "targets": targets}


def _pair(heads, batch, seed=0):
    jm = _jax_model(heads)
    variables = cached_init(jm, jax.random.PRNGKey(seed),
                            dict(tree_map(jnp.asarray, batch), **META), False)
    tm = _port_model(heads).eval()
    tm.load_state_dict(params_from_jax(jax.device_get(variables["params"])),
                       strict=True)
    return jm, variables, tm


def _port_out(tm, batch):
    with torch.no_grad():
        return tm.eval()(dict(tree_map(torch.from_numpy, batch), **META))


@pytest.mark.parametrize("case", sorted(HEADS))
def test_vilt_forward_matches_jax(case):
    batch = _batch()
    jm, variables, tm = _pair(HEADS[case], batch)
    want = jm.apply(variables, dict(tree_map(jnp.asarray, batch), **META),
                    False)
    got = _port_out(tm, batch)
    assert set(got) == set(want)
    for key in ("scores", "logits"):
        if key in want:
            assert got[key].dtype == torch.float32
            assert tuple(got[key].shape) == tuple(want[key].shape)
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=ATOL,
                                       rtol=0)
    assert list(got.get("losses", {})) == list(want.get("losses", {}))
    for key, value in want.get("losses", {}).items():
        np.testing.assert_allclose(float(got["losses"][key]), float(value),
                                   rtol=1e-5)


def test_vilt_names_heads_as_flax_does():
    """Two heads of one class in one scope: ``MLPHead_0``, ``MLPHead_1``;
    the MLM heads are untied in ViLT (``cls.decoder``)."""
    heads = [dict(MLP, head_name="a"), dict(MLP, head_name="b"),
             {"type": "mlm", "hidden_size": 32, "vocab_size": 100}]
    tm = _port_model(heads)
    names = {n.split(".")[0] for n, _ in tm.named_parameters()}
    assert {"MLPHead_0", "MLPHead_1", "MLM_0"} <= names
    assert "MLM_0.cls.decoder.weight" in dict(tm.named_parameters())
    _, variables, _ = _pair(heads, _batch())
    assert {"MLPHead_0", "MLPHead_1", "MLM_0"} <= set(variables["params"])


def test_mlm_loss_is_zero_without_a_label():
    """Every position labelled -1 (the image positions always are): the
    masked mean gives 0, not NaN, in both packages."""
    batch = _batch(no_labels=True)
    jm, variables, tm = _pair(HEADS["itm_mlm"], batch)
    want = jm.apply(variables, dict(tree_map(jnp.asarray, batch), **META),
                    False)["losses"]["train/vqa2/masked_lm_loss"]
    got = _port_out(tm, batch)["losses"]["train/vqa2/masked_lm_loss"]
    assert float(want) == 0.0 and float(got) == 0.0


@pytest.fixture
def jax_no_dropout(monkeypatch):
    """Every JAX ``TransformerConfig`` built at dropout 0 (ViLT's text
    embeddings and encoder read no rate from the config)."""
    from mmf_tpu.modules.transformer import TransformerConfig

    init = TransformerConfig.__init__

    def zero(self, *args, **kwargs):
        init(self, *args, **kwargs)
        object.__setattr__(self, "hidden_dropout_prob", 0.0)
        object.__setattr__(self, "attention_probs_dropout_prob", 0.0)

    monkeypatch.setattr(TransformerConfig, "__init__", zero)


def port_no_dropout(model):
    """The port's counterpart: every rate of the built model to 0."""
    from mmf_tpu_torch.modules import transformer as T

    for m in model.modules():
        if isinstance(getattr(m, "config", None), T.TransformerConfig):
            m.config = dataclasses.replace(
                m.config, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
        if isinstance(m, T.Dropout):
            m.rate = 0.0
    return model


def _rel_err(a, b, floor=1e-8):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              floor)


def _grads(heads, batch):
    jm, variables, tm = _pair(heads, batch)
    jb = dict(tree_map(jnp.asarray, batch), **META)

    def loss(params):
        out = jm.apply({"params": params}, jb, True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.mean(v) for v in out["losses"].values())

    want = {k: v.numpy() for k, v in params_from_jax(jax.device_get(
        jax.jit(jax.grad(loss))(variables["params"]))).items()}
    port_no_dropout(tm).train()
    out = tm(dict(tree_map(torch.from_numpy, batch), **META))
    sum(v.mean() for v in out["losses"].values()).backward()
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tm.named_parameters()}
    return want, got


@pytest.mark.parametrize("case", ["mlm_multi_itm", "mlp_itm_mlm"])
def test_vilt_step0_gradients_match_jax(case, jax_no_dropout):
    heads = [dict(h, hidden_dropout_prob=0.0) for h in HEADS[case]]
    want, got = _grads(heads, _batch())
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        err = _rel_err(got[name], want[name], floor)
        assert err < 5e-4, f"gradient mismatch at {name}: rel {err:.2e}"
    # the masked pass reaches the text embeddings through the MLM loss
    if "mlm" in case:
        assert np.any(got["text_embeddings.text_embeddings.word_embeddings"
                          ".weight"])


TRAIN_CONFIG = {
    "training": {"lr_scheduler": True, "max_updates": 10,
                 "clip_gradients": True, "max_grad_l2_norm": 0.5},
    "optimizer": {"type": "adam_w", "params": {"lr": 1e-3, "eps": 1e-8}},
    "scheduler": {"type": "warmup_linear",
                  "params": {"num_warmup_steps": 2,
                             "num_training_steps": 10}},
}


def trajectory(jm, variables, tm, batch, meta, update_frequency, keys):
    """Four train steps on both sides from the same weights: the losses,
    and JAX's final params by port name."""
    from mmf_tpu.config import omega as jomega
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu.modules.optimizers import build_optimizer_transform
    from mmf_tpu.modules.schedulers import build_scheduler as j_scheduler
    from mmf_tpu.trainers.core import train_state as jts
    from mmf_tpu_torch.config import omega as tomega
    from mmf_tpu_torch.modules.losses import Losses
    from mmf_tpu_torch.modules.optimizers import build_optimizer
    from mmf_tpu_torch.modules.schedulers import (
        build_lr_scheduler,
        build_scheduler,
    )
    from mmf_tpu_torch.trainers.core import train_state as tts
    from mmf_tpu_torch.utils.general import clip_gradients_config

    jcfg = jomega.create(TRAIN_CONFIG)
    tx = build_optimizer_transform(
        jcfg, schedule_fn=j_scheduler(jcfg), max_grad_norm=0.5,
        weight_decay_mask=jm.get_weight_decay_mask(jcfg))
    jstep = jax.jit(jts.make_train_step(
        jm.apply, JLosses([]), tx, update_frequency=update_frequency,
        meta=meta))
    jstate = jts.create_train_state({"params": variables["params"]}, tx,
                                    jax.random.PRNGKey(1))
    tcfg = tomega.create(TRAIN_CONFIG)
    opt = build_optimizer(tcfg, tm,
                          weight_decay_mask=tm.get_weight_decay_mask(tcfg))
    tstep = tts.make_train_step(
        Losses([]), update_frequency=update_frequency,
        max_grad_norm=clip_gradients_config(tcfg), meta=meta)
    tstate = tts.create_train_state(
        tm, opt, seed=1,
        lr_scheduler=build_lr_scheduler(opt, build_scheduler(tcfg)))
    jbatch = tree_map(jnp.asarray, batch)
    j_losses, t_losses = [], []
    for _ in range(4):
        jstate, jrep = jstep(jstate, jbatch)
        tstate, trep = tstep(tstate, batch)
        j_losses.append(float(jrep["total_loss"]))
        t_losses.append(float(trep["total_loss"]))
        assert sorted(trep["losses"]) == sorted(jrep["losses"]) == keys
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-4,
                               err_msg=f"jax {j_losses}\nport {t_losses}")
    if update_frequency == 2:
        assert t_losses[1] == t_losses[0]
    return params_from_jax(jax.device_get(jstate.variables["params"]))


@pytest.mark.parametrize("update_frequency", [1, 2])
def test_vilt_train_steps_match_jax(update_frequency, jax_no_dropout):
    heads = [dict(h, hidden_dropout_prob=0.0)
             for h in HEADS["mlp_itm_mlm"]]
    batch = _batch()
    jm, variables, tm = _pair(heads, batch)
    port_no_dropout(tm)
    want = trajectory(jm, variables, tm, batch, META, update_frequency,
                      ["train/vqa2/itm_loss", "train/vqa2/masked_lm_loss",
                       "train/vqa2/vqa2_mlp"])
    for name, p in tm.named_parameters():
        if re.search(r"key\.bias$", name):
            # softmax is shift-invariant along keys: f32 noise on both
            # sides that Adam scales up (tests/test_torch_train_step.py)
            continue
        err = _rel_err(p.detach().numpy(), want[name].numpy())
        assert err < 1e-3, f"post-training weight mismatch {name}: {err:.2e}"


@pytest.mark.parametrize("case", ["mlp", "mlm_multi_itm"])
def test_vilt_params_round_trip_through_jax_converter(case):
    from mmf_tpu.utils.checkpoint_updater import (
        _flatten_flax,
        convert_torch_state_dict,
    )

    _, variables, tm = _pair(HEADS[case], _batch())
    params = jax.device_get(variables["params"])
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    converted, stats = convert_torch_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}, zeros)
    n_leaves = len(_flatten_flax(params))
    assert stats == {"matched": n_leaves, "missed": 0, "shape_mismatch": 0}
    want, got = _flatten_flax(params), _flatten_flax(converted)
    assert set(want) == set(got)
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(want[path]),
                                      err_msg="/".join(path))


def test_hf_vit_names_convert_as_in_jax():
    """An HF-named ViLT encoder (``encoder.layer.N.attention.attention.
    query``, ...) goes through the port's ``reference_key_map("vilt")``
    as through JAX's converter CLI (the same maps in the same order):
    the same entries match and miss on both sides. Three of the four
    dense layers a ViT layer has miss on both: ``HF_BERT_KEY_MAP`` holds
    the same patterns as ``HF_VIT_KEY_MAP`` for them, and the composed
    map keeps BERT's replacements (ROADMAP C)."""
    from mmf_tpu.utils.checkpoint_updater import (
        HF_BERT_KEY_MAP,
        MODEL_KEY_MAPS,
        convert_torch_state_dict,
    )
    from mmf_tpu_torch.utils.checkpoint_updater import (
        convert_reference_state_dict,
        reference_key_map,
    )

    cli_map = {r"^model\.": ""}  # tools/scripts/convert_checkpoint.py
    cli_map.update(MODEL_KEY_MAPS["vilt"])
    cli_map.update({k: v for k, v in HF_BERT_KEY_MAP.items()
                    if k != r"^bert\."})
    assert list(reference_key_map("vilt").items()) == list(cli_map.items())

    to_hf = [(r"layer_(\d+)\.attention_(query|key|value)\.",
              r"layer.\1.attention.attention.\2."),
             (r"layer_(\d+)\.attention_output_dense",
              r"layer.\1.attention.output.dense"),
             (r"layer_(\d+)\.(layernorm_before|layernorm_after)",
              r"layer.\1.\2"),
             (r"layer_(\d+)\.intermediate_dense",
              r"layer.\1.intermediate.dense"),
             (r"layer_(\d+)\.output_dense", r"layer.\1.output.dense")]
    _, variables, tm = _pair(HEADS["mlp"], _batch())
    hf = {}
    for name, value in tm.state_dict().items():
        for pattern, repl in to_hf:
            name = re.sub(pattern, repl, name)
        hf["model." + name] = value.numpy()
    assert not any(re.search(r"layer_\d", k) for k in hf)
    _, stats = convert_reference_state_dict(hf, tm.state_dict(),
                                            reference_key_map("vilt"))
    zeros = jax.tree_util.tree_map(np.zeros_like,
                                   jax.device_get(variables["params"]))
    _, jstats = convert_torch_state_dict(hf, zeros, key_map=cli_map)
    assert stats == jstats
    layers = SMALL["num_hidden_layers"]
    assert stats["missed"] == 3 * 2 * layers and stats[
        "shape_mismatch"] == 0
