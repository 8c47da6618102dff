"""M4C in the port against the JAX package on the CPU.

A small M4C (TextBert 2 x 32 with 2 heads, MMT 2 x 32 with 4 heads, the
fc7 layers at their real 2048, 5 objects, 6 OCR tokens, 12 decode
steps, 40 answers) initialised in JAX, its params carried across by
``params_from_jax``, the same numpy inputs through both, f32. The
rates of dropout are 0 where training passes are compared: the config
keys ``obj.dropout_prob``, ``ocr.dropout_prob`` and the ``text_bert`` /
``mmt`` sections' ``hidden_dropout_prob`` and
``attention_probs_dropout_prob`` reach every one of them in both
packages.

- The teacher-forced scores (training mode) within 2e-5, the repo's f32
  bar.
- The greedy decode (evaluation): the scores of the last pass within
  2e-5, and its argmax at each of the 12 steps equal, each step's top-2
  margin in JAX's scores at least 10x the tolerance (so that an equal
  argmax is not luck). The port's decode over the cached prefix K/V
  against the same decode by 12 full passes of ``MMT.forward`` (the
  reference's algorithm): the same tokens, scores within 2e-5.
- The encoder's ``prefix_kvs`` / ``return_kv`` / ``output_hidden_states``
  against JAX's.
- The loss (``m4c_decoding_bce_with_mask``) rtol 1e-5; step-0 gradients
  relative 5e-4 over a floor of 1e-3 of the largest; a 4-step Adam
  trajectory with the lr multipliers (text_bert and the fc7 layers at
  0.1) and the warmup multi-step schedule: losses rtol 2e-4, parameters
  relative 1e-3 (as the other models' trajectories).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import registries_restored, tree_map

torch.set_num_threads(2)  # several test workers share the host

ATOL = 2e-5
B, T, OBJ, OCR, DEC, ANSWERS = 4, 6, 5, 6, 12, 40
META = {"dataset_name": "textvqa", "dataset_type": "train"}
TRAIN_CONFIG = {
    "training": {"lr_scheduler": True, "max_updates": 10,
                 "clip_gradients": True, "max_grad_l2_norm": 0.5},
    "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "eps": 1e-8}},
    "scheduler": {"type": "multi_step",
                  "params": {"use_warmup": True, "lr_steps": [3],
                             "lr_ratio": 0.1, "warmup_iterations": 2,
                             "warmup_factor": 0.25}},
}


def model_config(dropout=0.0):
    from mmf_tpu.config.configuration import load_yaml

    mc = load_yaml("configs/models/m4c/defaults.yaml")["model_config"]["m4c"]
    rates = {"hidden_dropout_prob": dropout,
             "attention_probs_dropout_prob": dropout}
    mc["text_bert"].update({"num_hidden_layers": 2, "vocab_size": 64,
                            "hidden_size": 32, "num_attention_heads": 2,
                            **rates})
    mc["mmt"].update({"hidden_size": 32, "num_hidden_layers": 2,
                      "num_attention_heads": 4, **rates})
    mc["obj"]["dropout_prob"] = dropout
    mc["ocr"]["dropout_prob"] = dropout
    mc["ocr"]["mmt_in_dim"] = 300 + 604 + 2048 + OCR
    mc["classifier"]["ocr_max_num"] = OCR
    mc["classifier"]["ocr_ptr_net"] = {"hidden_size": 32,
                                       "query_key_size": 32}
    mc["datasets"] = "textvqa"
    return mc


def make_batch(seed=0):
    """Inputs in the TextVQA dataset's layout; ragged text, objects and
    OCR tokens, one sample without OCR tokens; teacher-forced indices
    over answers and OCR copies, with targets and a loss mask."""
    rng = np.random.RandomState(seed)
    text_len = np.array([T, T - 2, 3, T - 1])
    obj_n = np.array([OBJ, OBJ - 1, 2, OBJ])
    ocr_n = np.array([OCR, 3, 0, OCR - 2])
    fasttext = rng.randn(B, OCR, 300).astype(np.float32)
    phoc = (rng.rand(B, OCR, 604) < 0.05).astype(np.float32)
    for i, n in enumerate(ocr_n):
        fasttext[i, n:] = 0
        phoc[i, n:] = 0
    order = np.zeros((B, OCR, OCR), np.float32)
    for i, n in enumerate(ocr_n):
        order[i, :n, :n] = np.eye(n)
    prev = rng.randint(0, ANSWERS + OCR, (B, DEC))
    prev[:, 0] = 1
    mask = (np.arange(DEC)[None] < rng.randint(2, DEC, (B, 1))).astype(
        np.float32)
    targets = (rng.rand(B, DEC, ANSWERS + OCR) < 0.05).astype(np.float32)
    return {
        "text": rng.randint(1, 64, (B, T)).astype(np.int64),
        "text_len": text_len.astype(np.int64),
        "image_feature_0": rng.randn(B, OBJ, 2048).astype(np.float32),
        "image_info_0": {"max_features": obj_n.astype(np.int64)},
        "obj_bbox_coordinates": rng.rand(B, OBJ, 4).astype(np.float32),
        "context_feature_0": fasttext,
        "context_feature_1": phoc,
        "context_info_0": {"max_features": ocr_n.astype(np.int64)},
        "image_feature_1": rng.randn(B, 2 * OCR, 2048).astype(np.float32),
        "order_vectors": order,
        "ocr_bbox_coordinates": rng.rand(B, OCR, 4).astype(np.float32),
        "train_prev_inds": prev.astype(np.int64),
        "train_loss_mask": mask,
        "targets": targets,
    }


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, jitted eval / train applies, the port
    model with the same weights) at dropout 0. Both models read the
    answer space from their registries, which hold it for the module."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.utils.env import setup_imports as jax_imports
    from mmf_tpu_torch.common.registry import registry as preg
    from mmf_tpu_torch.models.m4c import M4C

    jax_imports()
    with registries_restored():
        for reg in (jreg, preg):
            reg.register("textvqa_num_final_outputs", ANSWERS + OCR)
        jm = jreg.get_model_class("m4c")(config=model_config())
        batch = make_batch()
        jb = tree_map(jnp.asarray, batch)
        variables = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              False))(jb)
        tm = M4C(model_config())
        tm.load_state_dict(params_from_jax(jax.device_get(
            variables["params"])), strict=True)
        rngs = {"dropout": jax.random.PRNGKey(0)}
        yield {
            "jm": jm, "variables": variables, "tm": tm, "batch": batch,
            "jax_eval": jax.jit(
                lambda v, b: jm.apply(v, b, False)["scores"]),
            "jax_train": jax.jit(
                lambda v, b: jm.apply(v, b, True, rngs=rngs)["scores"]),
        }


def _port(batch):
    return tree_map(torch.from_numpy, batch)


def test_teacher_forced_scores_match_jax(pair):
    want = np.asarray(pair["jax_train"](pair["variables"],
                                        tree_map(jnp.asarray,
                                                 pair["batch"])))
    tm = pair["tm"].train()
    with torch.no_grad():
        got = tm(_port(pair["batch"]))["scores"].numpy()
    assert got.shape == (B, DEC, ANSWERS + OCR)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_greedy_decode_matches_jax_token_for_token(pair):
    want = np.asarray(pair["jax_eval"](pair["variables"],
                                       tree_map(jnp.asarray, pair["batch"])))
    tm = pair["tm"].eval()
    with torch.no_grad():
        got = tm(_port(pair["batch"]))["scores"].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > 10 * ATOL, margin.min()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the decode feeds both kinds of index back
    tokens = want.argmax(-1)
    assert (tokens >= ANSWERS).any() and (tokens < ANSWERS).any()


def test_cached_prefix_decode_equals_full_recompute(pair):
    """The port's prefill + decode_step loop against the reference's
    algorithm: 12 full passes of MMT.forward, each step's argmax fed
    back."""
    from mmf_tpu_torch.models.m4c import M4C

    tm = pair["tm"].eval()
    with torch.no_grad():
        cached = tm(_port(pair["batch"]))["scores"]
        encoded = tm._encode(_port(pair["batch"]))
        inds = torch.zeros(B, DEC, dtype=torch.long)
        inds[:, 0] = 1
        for _ in range(DEC):
            res = tm.mmt(*encoded, tm.classifier_w, inds)
            full = M4C._scores(tm, res["mmt_dec_output"],
                               res["mmt_ocr_output"], encoded[5])
            inds = torch.cat([inds[:, :1], full.argmax(-1)[:, :-1]], 1)
    np.testing.assert_array_equal(cached.argmax(-1).numpy(),
                                  full.argmax(-1).numpy())
    np.testing.assert_allclose(cached.numpy(), full.numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["return_kv", "prefix_kvs",
                                  "output_hidden_states"])
def test_encoder_prefix_kv_modes_match_jax(mode):
    from mmf_tpu.modules import transformer as JT
    from mmf_tpu_torch.modules import transformer as PT

    cfg = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 32).astype(np.float32)
    prefix = [(rng.randn(2, 4, 5, 8).astype(np.float32),
               rng.randn(2, 4, 5, 8).astype(np.float32)) for _ in range(2)]
    bias = np.where(rng.rand(2, 1, 7, 12) < 0.2, -10000.0, 0.0).astype(
        np.float32)
    kwargs = {mode: True} if mode != "prefix_kvs" else {}
    jkw = dict(kwargs)
    if mode == "prefix_kvs":
        jkw["prefix_kvs"] = [tuple(map(jnp.asarray, kv)) for kv in prefix]
        jbias = jnp.asarray(bias)
    else:
        jbias = jnp.asarray(bias[..., 5:])
    jenc = JT.TransformerEncoder(JT.TransformerConfig(**cfg))
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jbias,
                          True, **jkw)
    want = jenc.apply(variables, jnp.asarray(x), jbias, True, **jkw)
    penc = PT.TransformerEncoder(PT.TransformerConfig(**cfg))
    state = params_from_jax(jax.device_get(variables["params"]))
    penc.load_state_dict(state, strict=True)
    pkw = dict(kwargs)
    if mode == "prefix_kvs":
        pkw["prefix_kvs"] = [tuple(map(torch.from_numpy, kv))
                             for kv in prefix]
    with torch.no_grad():
        got = penc(torch.from_numpy(x), torch.from_numpy(np.array(jbias)),
                   **pkw)
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = [t.numpy() for t in jax.tree_util.tree_leaves(got)]
    assert len(flat_got) == len(flat_want) == {
        "return_kv": 5, "prefix_kvs": 1, "output_hidden_states": 4}[mode]
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)


def _jax_loss(jm, params, batch, rngs):
    from mmf_tpu.modules.losses import MMFLoss

    out = jm.apply({"params": params}, dict(batch, **META), True, rngs=rngs)
    return list(MMFLoss("m4c_decoding_bce_with_mask")(
        dict(batch, **META), out).values())[0]


def test_loss_and_step0_gradients_match_jax(pair):
    from mmf_tpu_torch.modules.losses import MMFLoss

    jb = tree_map(jnp.asarray, pair["batch"])
    rngs = {"dropout": jax.random.PRNGKey(0)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(pair["jm"], p, jb, rngs)))(
            pair["variables"]["params"])
    want = {k: v.numpy() for k, v in
            params_from_jax(jax.device_get(jgrads)).items()}
    tm = pair["tm"].train()
    tm.zero_grad()
    pb = dict(_port(pair["batch"]), **META)
    loss = list(MMFLoss("m4c_decoding_bce_with_mask")(pb, tm(pb)).values())[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    tm.zero_grad()
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        scale = max(float(np.abs(want[name]).max()), floor)
        err = float(np.abs(got[name] - want[name]).max()) / scale
        assert err < 5e-4, f"gradient mismatch at {name}: rel {err:.2e}"
    # the loss reaches the question, the objects, the OCR tokens and the
    # answer table through the decode embeddings
    for name in ("text_bert.embeddings.word_embeddings.weight",
                 "obj_faster_rcnn_fc7.lc.weight",
                 "ocr_faster_rcnn_fc7.lc.weight", "classifier_w",
                 "mmt.prev_pred_embeddings.ans_layer_norm.weight"):
        assert np.abs(got[name]).max() > 0, name


def test_adam_trajectory_with_lr_multipliers_matches_jax(pair):
    from mmf_tpu.config import omega as jomega
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu.modules.optimizers import build_optimizer_transform
    from mmf_tpu.modules.schedulers import build_scheduler as j_scheduler
    from mmf_tpu.trainers.core import train_state as jts
    from mmf_tpu_torch.config import omega as tomega
    from mmf_tpu_torch.models.m4c import M4C
    from mmf_tpu_torch.modules.losses import Losses
    from mmf_tpu_torch.modules.optimizers import build_optimizer
    from mmf_tpu_torch.modules.schedulers import (
        build_lr_scheduler,
        build_scheduler,
    )
    from mmf_tpu_torch.trainers.core import train_state as tts
    from mmf_tpu_torch.utils.general import clip_gradients_config

    jm, variables = pair["jm"], pair["variables"]
    losses = [{"type": "m4c_decoding_bce_with_mask"}]
    jcfg = jomega.create(TRAIN_CONFIG)
    multipliers = jm.get_lr_multipliers(jcfg)
    assert multipliers["text_bert"] == multipliers["obj_faster_rcnn_fc7"] \
        == 0.1
    tx = build_optimizer_transform(jcfg, schedule_fn=j_scheduler(jcfg),
                                   max_grad_norm=0.5,
                                   lr_multipliers=multipliers)
    jstep = jax.jit(jts.make_train_step(jm.apply, JLosses(losses), tx,
                                        meta=META))
    jstate = jts.create_train_state({"params": variables["params"]}, tx,
                                    jax.random.PRNGKey(1))
    tm = M4C(model_config())
    tm.load_state_dict(pair["tm"].state_dict())
    tcfg = tomega.create(TRAIN_CONFIG)
    opt = build_optimizer(tcfg, tm,
                          lr_multipliers=tm.get_lr_multipliers(tcfg))
    tstep = tts.make_train_step(
        Losses(losses), max_grad_norm=clip_gradients_config(tcfg),
        meta=META)
    tstate = tts.create_train_state(
        tm, opt, seed=1,
        lr_scheduler=build_lr_scheduler(opt, build_scheduler(tcfg)))
    jbatch = tree_map(jnp.asarray, pair["batch"])
    j_losses, t_losses = [], []
    for _ in range(4):
        jstate, jrep = jstep(jstate, jbatch)
        tstate, trep = tstep(tstate, pair["batch"])
        j_losses.append(float(jrep["total_loss"]))
        t_losses.append(float(trep["total_loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-4,
                               err_msg=f"jax {j_losses}\nport {t_losses}")
    assert t_losses[-1] < t_losses[0]
    want = params_from_jax(jax.device_get(jstate.variables["params"]))
    start = pair["tm"].state_dict()
    for name, p in tm.named_parameters():
        if name.endswith("key.bias"):
            # softmax is shift-invariant along keys: f32 noise on both
            # sides that Adam scales up (tests/test_torch_train_step.py)
            continue
        got, ref = p.detach().numpy(), want[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-8)
        err = float(np.abs(got - ref).max()) / scale
        assert err < 1e-3, f"post-training weight mismatch {name}: {err:.2e}"
    # the multipliers move text_bert 10x less than the MMT (Adam's steps
    # are ~lr each)
    moved = {k: float((tm.state_dict()[k] - start[k]).abs().max())
             for k in ("text_bert.encoder.layer_0.attention.query.weight",
                       "mmt.encoder.layer_0.attention.query.weight")}
    ratio = moved["text_bert.encoder.layer_0.attention.query.weight"] / \
        moved["mmt.encoder.layer_0.attention.query.weight"]
    assert 0.05 < ratio < 0.2, moved


def test_port_dropout_rates_come_from_the_config():
    """The rates the tests above zero are the config's: a forward in
    training mode at the defaults' 0.1 needs a dropout generator, and
    the sections' keys reach every Dropout and the attention."""
    from mmf_tpu_torch.common.registry import registry as preg
    from mmf_tpu_torch.models.m4c import M4C
    from mmf_tpu_torch.modules import transformer as PT

    with registries_restored():
        preg.register("textvqa_num_final_outputs", ANSWERS + OCR)
        rates = {m.rate for m in M4C(model_config(0.1)).modules()
                 if isinstance(m, PT.Dropout)}
        cfgs = {(m.config.hidden_dropout_prob,
                 m.config.attention_probs_dropout_prob)
                for m in M4C(model_config(0.3)).modules()
                if isinstance(getattr(m, "config", None),
                              PT.TransformerConfig)}
    assert rates == {0.1}
    assert cfgs == {(0.3, 0.3)}


def test_fc7_encoder_takes_pickled_weights_as_jax(tmp_path):
    """``finetune_faster_rcnn_fpn_fc7`` through both packages' image
    encoder factories with pickled fc7 weights ([out, in]) and bias: the
    same relu(x W^T + b), the width from the bias, and the pickles kept
    through the port's ``init_weights``."""
    import pickle

    from mmf_tpu.modules.encoders import build_image_encoder as jax_build
    from mmf_tpu_torch.models.base_model import BaseModel
    from mmf_tpu_torch.modules.encoders import build_image_encoder

    rng = np.random.RandomState(4)
    weights = rng.randn(24, 16).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    files = {}
    for name, arr in (("weights_file", weights), ("bias_file", bias)):
        files[name] = str(tmp_path / f"{name}.pkl")
        with open(files[name], "wb") as f:
            pickle.dump(arr, f)
    config = {"type": "finetune_faster_rcnn_fpn_fc7",
              "params": {"in_dim": 16, **files}}
    x = rng.randn(3, 5, 16).astype(np.float32)
    jenc = jax_build(config, direct_features=True)
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jenc.apply(variables, jnp.asarray(x)))

    model = BaseModel()
    model.encoder = build_image_encoder(config, direct_features=True)
    model.init_weights(torch.Generator().manual_seed(0))
    assert model.encoder.out_dim == 24
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 5, 24)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.maximum(x @ weights.T + bias, 0),
                               atol=1e-5, rtol=0)
