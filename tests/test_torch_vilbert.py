"""ViLBERT in the port against the JAX package on the CPU: a small
ViLBERT (4 text layers, 2 image layers, 2 co-attention layers; the
config of ``tests/models/test_mmbt_vilbert.py``) initialised in JAX, its
params carried across by ``params_from_jax``, and the same numpy inputs
through both. JAX runs its plain (XLA) attention, the port its plain
versions. Bars: f32 outputs atol 2e-5 (the repo's parity bar), losses
rtol 1e-5; step-0 gradients relative 5e-4 over a floor of 1e-3 of the
global gradient scale, and a 4-step AdamW trajectory with losses rtol
2e-4 and parameters relative 1e-3 (those of
``tests/test_torch_train_step.py``)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import cached_init, tree_map

torch.set_num_threads(2)  # several test workers share the host

SMALL = {
    "vocab_size": 100,
    "hidden_size": 32,
    "num_hidden_layers": 4,
    "num_attention_heads": 4,
    "intermediate_size": 64,
    "v_feature_size": 16,
    "v_hidden_size": 24,
    "v_num_hidden_layers": 2,
    "v_num_attention_heads": 4,
    "v_intermediate_size": 48,
    "bi_hidden_size": 24,
    "bi_num_attention_heads": 4,
    "v_target_size": 11,
    "v_biattention_id": [0, 1],
    "t_biattention_id": [2, 3],
    "num_labels": 3,
    "dtype": "float32",
}
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
              "v_hidden_dropout_prob": 0.0,
              "v_attention_probs_dropout_prob": 0.0}
META = {"dataset_name": "vqa2", "dataset_type": "train"}
ATOL = 2e-5
B, T, R = 4, 8, 5


def _config(load_yaml, overrides):
    mc = load_yaml("configs/models/vilbert/defaults.yaml")["model_config"][
        "vilbert"]
    mc.update({"training_head_type": "classification", **SMALL,
               **overrides})
    return mc


def _jax_model(overrides):
    from mmf_tpu.common.registry import registry
    from mmf_tpu.config.configuration import load_yaml
    from mmf_tpu.utils.env import setup_imports

    setup_imports()
    return registry.get_model_class("vilbert")(
        config=_config(load_yaml, overrides))


def _port_model(overrides):
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    return registry.get_model_class("vilbert")(
        config=_config(load_yaml, overrides))


def _info(rng, n, loc_width=5):
    probs = rng.rand(n, R, SMALL["v_target_size"]).astype(np.float32)
    probs[:, :, 0] = 0.0  # the KLD's zero-target branch
    probs /= probs.sum(-1, keepdims=True)
    return {"max_features": np.array([R, R - 1, R - 2, R][:n], np.int32),
            "bbox": rng.rand(n, R, loc_width).astype(np.float32),
            "cls_prob": probs}


def _batch(head="classification", loc_width=5, info=True, seed=0):
    rng = np.random.RandomState(seed)
    batch = {
        "input_ids": rng.randint(1, SMALL["vocab_size"], (B, T)).astype(
            np.int32),
        "input_mask": np.ones((B, T), np.int32),
        "segment_ids": np.zeros((B, T), np.int32),
        "targets": np.zeros((B, SMALL["num_labels"]), np.float32),
    }
    batch["input_mask"][0, T - 3:] = 0
    batch["input_ids"][0, T - 3:] = 0
    batch["segment_ids"][1, T // 2:] = 1
    batch["targets"][np.arange(B), rng.randint(0, 3, B)] = 1.0
    feats = rng.randn(B, R, SMALL["v_feature_size"]).astype(np.float32)
    if head == "nlvr2":
        other = rng.randn(B, R, SMALL["v_feature_size"]).astype(np.float32)
        batch["img0"] = {"image_feature_0": feats,
                         "image_info_0": _info(rng, B, loc_width)}
        batch["img1"] = {"image_feature_0": other,
                         "image_info_0": _info(rng, B, loc_width)}
        return batch
    batch["image_feature_0"] = feats
    if info:
        batch["image_info_0"] = _info(rng, B, loc_width)
    if head == "pretraining":
        lm = np.where(rng.rand(B, T) < 0.4, batch["input_ids"], -1)
        lm[0, T - 3:] = -1
        lm[:, 1] = batch["input_ids"][:, 1]
        batch["lm_label_ids"] = lm.astype(np.int32)
        labels = np.where(rng.rand(B, R) < 0.4, 1, -1)
        labels[:, 2] = 1
        batch["image_labels"] = labels.astype(np.int32)
    return batch


def _pair(overrides, batch, seed=0):
    """The JAX model and its variables, and the port model holding the
    same weights (eval mode)."""
    jm = _jax_model(overrides)
    jb = dict(tree_map(jnp.asarray, batch), **META)
    variables = cached_init(jm, jax.random.PRNGKey(seed), jb, False)
    tm = _port_model(overrides).eval()
    tm.load_state_dict(params_from_jax(jax.device_get(variables["params"])),
                       strict=True)
    return jm, variables, tm


def _jax_out(jm, variables, batch):
    return jm.apply(variables, dict(tree_map(jnp.asarray, batch), **META),
                    False)


def _port_out(tm, batch):
    with torch.no_grad():
        return tm.eval()(dict(tree_map(torch.from_numpy, batch), **META))


CASES = {  # name -> (model overrides, batch arguments)
    "mul": ({}, {}),
    "sum": ({"fusion_method": "sum"}, {}),
    "nlvr2": ({"training_head_type": "nlvr2"}, {"head": "nlvr2"}),
    "pretraining_kld": ({"training_head_type": "pretraining"},
                        {"head": "pretraining"}),
    "pretraining_mse": ({"training_head_type": "pretraining",
                         "visual_target": 1}, {"head": "pretraining"}),
    "dynamic_attention": ({"dynamic_attention": True}, {}),
    "without_coattention": ({"with_coattention": False}, {}),
    "fixed_layers": ({"fixed_t_layer": 2, "fixed_v_layer": 1,
                      "v_biattention_id": [1, 2]}, {}),
    "location_width_4": ({}, {"loc_width": 4}),
    "no_features_info": ({}, {"info": False}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vilbert_forward_matches_jax(case):
    overrides, batch_args = CASES[case]
    batch = _batch(**batch_args)
    jm, variables, tm = _pair(overrides, batch)
    want = _jax_out(jm, variables, batch)
    got = _port_out(tm, batch)
    assert set(got) == set(want)
    for key in ("scores", "seq_relationship_score"):
        if key in want:
            assert got[key].dtype == torch.float32
            assert tuple(got[key].shape) == tuple(want[key].shape)
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=ATOL,
                                       rtol=0)
    if "losses" in want:
        assert list(got["losses"]) == list(want["losses"]) == [
            "train/vqa2/masked_lm_loss", "train/vqa2/masked_img_loss"]
        for key, value in want["losses"].items():
            np.testing.assert_allclose(float(got["losses"][key]),
                                       float(value), rtol=1e-5)
    assert tm.bert.v_location_embeddings.weight.shape[1] == batch_args.get(
        "loc_width", 5)


def test_location_width_is_taken_from_the_batch():
    """``v_location_embeddings`` takes its input width from the data, as
    flax's Dense does: ``materialize`` sizes it before weights are
    drawn; a state dict sizes it when it loads."""
    tm = _port_model({})
    assert tm.has_uninitialized_params()
    tm.materialize(tree_map(torch.from_numpy, _batch(loc_width=4)))
    assert not tm.has_uninitialized_params()
    assert tuple(tm.bert.v_location_embeddings.weight.shape) == (24, 4)
    tm.init_weights(torch.Generator().manual_seed(0))
    fresh = _port_model({})
    fresh.load_state_dict(tm.state_dict(), strict=True)
    assert tuple(fresh.bert.v_location_embeddings.weight.shape) == (24, 4)
    # no features info: the zero locations are 5 wide
    tm = _port_model({}).materialize(tree_map(torch.from_numpy,
                                              _batch(info=False)))
    assert tuple(tm.bert.v_location_embeddings.weight.shape) == (24, 5)


def _rel_err(a, b, floor=1e-8):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              floor)


def _loss_names(head):
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu_torch.modules.losses import Losses

    names = [] if head == "pretraining" else ["logit_bce"]
    return JLosses(names), Losses(names)


def _grads(overrides, batch, head):
    """(JAX's and the port's step-0 gradients by port name, port model)."""
    from mmf_tpu_torch.modules.transformer import dropout_generator

    overrides = dict(overrides, **NO_DROPOUT, training_head_type=head)
    jm, variables, tm = _pair(overrides, batch)
    jlosses, tlosses = _loss_names(head)
    jb = dict(tree_map(jnp.asarray, batch), **META)

    def loss(params):
        out = jm.apply({"params": params}, jb, True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        values = dict(out.get("losses", {}), **jlosses(jb, out))
        return sum(jnp.mean(v) for v in values.values())

    want = {k: v.numpy() for k, v in params_from_jax(jax.device_get(
        jax.grad(loss)(variables["params"]))).items()}
    tm.train()
    tb = dict(tree_map(torch.from_numpy, batch), **META)
    # the ITM score's fixed dropout at 0.1 (no loss reads the score)
    with dropout_generator(torch.Generator().manual_seed(0)):
        out = tm(tb)
    values = dict(out.get("losses", {}), **tlosses(tb, out))
    sum(v.mean() for v in values.values()).backward()
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tm.named_parameters()}
    return want, got


@pytest.mark.parametrize("head", ["classification", "pretraining"])
def test_vilbert_step0_gradients_match_jax(head):
    want, got = _grads({}, _batch(head=head), head)
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        err = _rel_err(got[name], want[name], floor)
        assert err < 5e-4, f"gradient mismatch at {name}: rel {err:.2e}"


def test_fixed_layers_get_zero_gradients():
    """``fixed_t_layer`` / ``fixed_v_layer`` detach the frozen prefix (JAX
    stops the gradient): its parameters get none, in both packages."""
    overrides = {"fixed_t_layer": 2, "fixed_v_layer": 1,
                 "v_biattention_id": [1, 2]}
    want, got = _grads(overrides, _batch(), "classification")
    frozen = re.compile(r"bert\.(embeddings|v_image_embeddings|"
                        r"v_location_embeddings|v_embeddings_ln|layer_[01]\.|"
                        r"v_layer_0\.)")
    names = [n for n in want if frozen.match(n)]
    assert len(names) > 20
    for name in names:
        assert not np.any(want[name]) and not np.any(got[name]), name
    live = [n for n in want if n not in names and np.any(want[n])]
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in live:
        assert _rel_err(got[name], want[name], floor) < 5e-4, name


TRAIN_CONFIG = {
    "training": {"lr_scheduler": True, "max_updates": 10,
                 "clip_gradients": True, "max_grad_l2_norm": 0.5},
    "optimizer": {"type": "adam_w", "params": {"lr": 1e-3, "eps": 1e-8}},
    "scheduler": {"type": "warmup_cosine",
                  "params": {"num_warmup_steps": 2,
                             "num_training_steps": 10}},
}


@pytest.mark.parametrize("update_frequency", [1, 2])
def test_vilbert_train_steps_match_jax(update_frequency):
    from mmf_tpu.config import omega as jomega
    from mmf_tpu.modules.optimizers import build_optimizer_transform
    from mmf_tpu.modules.schedulers import build_scheduler as j_scheduler
    from mmf_tpu.trainers.core import train_state as jts
    from mmf_tpu_torch.config import omega as tomega
    from mmf_tpu_torch.modules.optimizers import build_optimizer
    from mmf_tpu_torch.modules.schedulers import (
        build_lr_scheduler,
        build_scheduler,
    )
    from mmf_tpu_torch.trainers.core import train_state as tts
    from mmf_tpu_torch.utils.general import clip_gradients_config

    batch = _batch()
    jm, variables, tm = _pair(dict(NO_DROPOUT), batch)
    jlosses, tlosses = _loss_names("classification")
    jcfg = jomega.create(TRAIN_CONFIG)
    tx = build_optimizer_transform(
        jcfg, schedule_fn=j_scheduler(jcfg), max_grad_norm=0.5,
        weight_decay_mask=jm.get_weight_decay_mask(jcfg))
    jstep = jax.jit(jts.make_train_step(
        jm.apply, jlosses, tx, update_frequency=update_frequency,
        meta=META))
    jstate = jts.create_train_state({"params": variables["params"]}, tx,
                                    jax.random.PRNGKey(1))
    tcfg = tomega.create(TRAIN_CONFIG)
    opt = build_optimizer(tcfg, tm,
                          weight_decay_mask=tm.get_weight_decay_mask(tcfg))
    tstep = tts.make_train_step(
        tlosses, update_frequency=update_frequency,
        max_grad_norm=clip_gradients_config(tcfg), meta=META)
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
        assert list(trep["losses"]) == list(jrep["losses"]) == [
            "train/vqa2/logit_bce"]
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-4,
                               err_msg=f"jax {j_losses}\nport {t_losses}")
    assert t_losses[1] == t_losses[0] and len(set(t_losses)) == 3
    want = params_from_jax(jax.device_get(jstate.variables["params"]))
    for name, p in tm.named_parameters():
        if re.search(r"key\d?\.bias$", name):
            # softmax is shift-invariant along keys: f32 noise on both
            # sides that Adam scales up (tests/test_torch_train_step.py)
            continue
        err = _rel_err(p.detach().numpy(), want[name].numpy())
        assert err < 1e-3, f"post-training weight mismatch {name}: {err:.2e}"


@pytest.mark.parametrize("head", ["classification", "pretraining"])
def test_vilbert_params_round_trip_through_jax_converter(head):
    from mmf_tpu.utils.checkpoint_updater import (
        _flatten_flax,
        convert_torch_state_dict,
    )

    overrides = {"training_head_type": head}
    batch = _batch(head=head)
    _, variables, tm = _pair(overrides, batch)
    params = jax.device_get(variables["params"])
    sd = tm.state_dict()
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    converted, stats = convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, zeros)
    n_leaves = len(_flatten_flax(params))
    assert stats == {"matched": n_leaves, "missed": 0, "shape_mismatch": 0}
    want, got = _flatten_flax(params), _flatten_flax(converted)
    assert set(want) == set(got)
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(want[path]),
                                      err_msg="/".join(path))


# the port's names -> a reference MMF ViLBERT's (VILBERT_KEY_MAP inverted)
TO_REFERENCE = [
    (r"^bert\.layer_(\d+)\.(query|key|value)\.",
     r"bert.encoder.layer.\1.attention.self.\2."),
    (r"^bert\.layer_(\d+)\.attention_output_dense",
     r"bert.encoder.layer.\1.attention.output.dense"),
    (r"^bert\.layer_(\d+)\.attention_ln",
     r"bert.encoder.layer.\1.attention.output.LayerNorm"),
    (r"^bert\.(v_)?layer_(\d+)\.intermediate_dense",
     r"bert.encoder.\1layer.\2.intermediate.dense"),
    (r"^bert\.(v_)?layer_(\d+)\.output_dense",
     r"bert.encoder.\1layer.\2.output.dense"),
    (r"^bert\.(v_)?layer_(\d+)\.output_ln",
     r"bert.encoder.\1layer.\2.output.LayerNorm"),
    (r"^bert\.v_layer_(\d+)\.attention_self\.",
     r"bert.encoder.v_layer.\1.attention.self."),
    (r"^bert\.v_layer_(\d+)\.attention_output_dense",
     r"bert.encoder.v_layer.\1.attention.output.dense"),
    (r"^bert\.v_layer_(\d+)\.attention_ln",
     r"bert.encoder.v_layer.\1.attention.output.LayerNorm"),
    (r"^bert\.c_layer_(\d+)\.((query|key|value)[12])\.",
     r"bert.encoder.c_layer.\1.biattention.\2."),
    (r"^bert\.c_layer_(\d+)\.biout_dense([12])",
     r"bert.encoder.c_layer.\1.biOutput.dense\2"),
    (r"^bert\.c_layer_(\d+)\.biout_ln([12])",
     r"bert.encoder.c_layer.\1.biOutput.LayerNorm\2"),
    (r"^bert\.c_layer_(\d+)\.([vt])_output_ln",
     r"bert.encoder.c_layer.\1.\2_output.LayerNorm"),
    (r"^bert\.c_layer_(\d+)\.([vt])_(intermediate|output)\.",
     r"bert.encoder.c_layer.\1.\2_\3.dense."),
    (r"^bert\.v_image_embeddings", "bert.v_embeddings.image_embeddings"),
    (r"^bert\.v_location_embeddings",
     "bert.v_embeddings.image_location_embeddings"),
    (r"^bert\.v_embeddings_ln", "bert.v_embeddings.LayerNorm"),
    (r"^bert\.embeddings\.layer_norm", "bert.embeddings.LayerNorm"),
    (r"^bert\.([tv])_pooler\.", r"bert.\1_pooler.dense."),
    (r"^bi_seq_relationship", "cls.bi_seq_relationship"),
]


@pytest.mark.parametrize("head", ["classification", "pretraining"])
def test_reference_named_state_dict_loads_through_vilbert_key_map(head):
    from mmf_tpu_torch.utils.checkpoint import load_model_weights

    overrides = {"training_head_type": head}
    batch = _batch(head=head)
    _, _, tm = _pair(overrides, batch)
    reference = {}
    for name, value in tm.state_dict().items():
        for pattern, repl in TO_REFERENCE:
            name = re.sub(pattern, repl, name)
        reference["model." + name] = value.clone()
    # every trunk name really is a reference one
    assert not any(re.search(r"layer_\d|_ln\b|biout", k) for k in reference
                   if k.startswith("model.bert."))
    fresh = _port_model(overrides)
    assert fresh.has_uninitialized_params()
    stats = load_model_weights(fresh, reference, "vilbert", strict=True)
    assert stats == {"matched": len(reference), "missed": 0,
                     "shape_mismatch": 0}
    for name, value in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name
    np.testing.assert_array_equal(_port_out(fresh, batch)["scores"].numpy(),
                                  _port_out(tm, batch)["scores"].numpy())


def _nce_numpy(v_logits, target, labels, index):
    """JAX's ``visual_target`` 2 formula (mmf_tpu/models/vilbert.py) in
    numpy, at the given negative indices."""
    bsz, nreg = v_logits.shape[:2]
    flat = target.reshape(bsz * nreg, -1)
    sample_v = np.concatenate([target[:, :, None], flat[index]], axis=2)
    score = np.einsum("brnd,brd->brn", sample_v.astype(np.float64),
                      v_logits.astype(np.float64))
    top = score.max(-1, keepdims=True)
    lse = top[..., 0] + np.log(np.exp(score - top).sum(-1))
    lp0 = score[..., 0] - lse
    mask = (labels == 1).astype(np.float64)
    return -(lp0 * mask).sum() / max(mask.sum(), 1.0)


def test_visual_target_2_loss_matches_numpy_at_the_ports_indices():
    """The NCE loss of ``visual_target`` 2, through the whole pretraining
    model, against a numpy transcription of JAX's formula at the indices
    the port drew (the random streams of the two frameworks differ)."""
    from mmf_tpu_torch.models.vilbert import nce_negative_index

    overrides = {"training_head_type": "pretraining", "visual_target": 2,
                 "num_negative": 10}
    batch = _batch(head="pretraining")
    _, _, tm = _pair(overrides, batch)
    captured = {}
    tm.img_head_decoder.register_forward_hook(
        lambda m, i, out: captured.setdefault("v_logits", out.detach()))
    got = float(_port_out(tm, batch)["losses"]["train/vqa2/masked_img_loss"])
    index = nce_negative_index(B, R, 10, torch.Generator().manual_seed(0))
    want = _nce_numpy(captured["v_logits"].numpy(),
                      batch["image_info_0"]["cls_prob"],
                      batch["image_labels"], index.numpy())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_visual_target_2_sampling_rules():
    """70% of the negatives across the batch, never from the region's own
    image; 30% inside its image, never the region itself; every other
    image and region reachable."""
    from mmf_tpu_torch.models.vilbert import nce_negative_index

    bsz, nreg, nneg = 4, 6, 40
    index = nce_negative_index(bsz, nreg, nneg,
                               torch.Generator().manual_seed(3)).numpy()
    n_across, n_inside = int(nneg * 0.7), int(nneg * 0.3)
    assert index.shape == (bsz, nreg, n_across + n_inside)
    assert index.min() >= 0 and index.max() < bsz * nreg
    rows = np.arange(bsz)[:, None, None]
    cols = np.arange(nreg)[None, :, None]
    across, inside = index[..., :n_across], index[..., n_across:]
    assert not np.any(across // nreg == rows)
    assert np.all(inside // nreg == rows)
    assert not np.any(inside % nreg == cols)
    for b in range(bsz):
        assert set(np.unique(across[b] // nreg)) == set(range(bsz)) - {b}
        for r in range(nreg):
            assert set(np.unique(inside[b, r] % nreg)) <= set(
                range(nreg)) - {r}
    # the same generator state gives the same draws
    again = nce_negative_index(bsz, nreg, nneg,
                               torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(again, index)
