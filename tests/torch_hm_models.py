"""Shared helpers of the Hateful Memes model tests
(``tests/test_torch_hm_{mmbt,fusions,unimodal}.py``): each model of
``flagship.HATEFUL_MEMES_CONFIGS`` built in JAX and in the port from its
project config at a small size (a 2-layer, 64-wide text encoder, a
vocabulary of 100, ResNet-152 on 32 px images, f32, dropout 0), the same
weights on both sides, and the comparisons: the eval forward, the
step-0 gradients and a 4-step AdamW trajectory with the BatchNorm
statistics.

JAX's weights are drawn with numpy into the shapes of
``jax.eval_shape(model.init)``: flax's own initialisers would spend
most of a test's time drawing ResNet-152's 60M weights with threefry.
Convolutions are He-normal over the fan-out (as the port's
``init_weights``), Dense kernels LeCun-normal, tables N(0, 0.02),
biases and BatchNorm statistics random, so that a mapping error shows.
JAX's gradient and its trajectory share one jitted
``value_and_grad``; its AdamW is the JAX package's optax chain, the
port's the port's train step.

In training mode a ResNet-152's BatchNorms normalise by each batch's
statistics, 155 deep, over as few as 4 values a channel at 32 px: f32
rounding that differs between the frameworks (the convolutions' sums)
grows through them to 0.26 of the largest feature (0.005 in a ResNet-50,
5e-5 in a ResNet-18, measured here), and Adam turns the f32 noise of
gradients near 0 into whole steps of either sign. So the gradients and
trajectories run in float64 on both sides (``Pair(key, f64=True)``: the
configs' compute dtype float64, JAX with x64 on for the pair's
computations), where the two ResNets agree within 4e-10. The eval
forward is compared in f32.
"""

import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

B, T, IMAGE, VOCAB = 4, 12, 32, 100
SMALL_TEXT = {"hidden_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "vocab_size": VOCAB}
META = {"dataset_name": "hateful_memes", "dataset_type": "train"}
TRAIN_CONFIG = {
    "training": {"lr_scheduler": True, "max_updates": 10,
                 "clip_gradients": False},
    "optimizer": {"type": "adam_w", "params": {"lr": 1e-3, "eps": 1e-8}},
    "scheduler": {"type": "warmup_linear",
                  "params": {"num_warmup_steps": 2,
                             "num_training_steps": 10}},
}


def _zero_classifier_dropout(cc):
    if cc and cc.get("type") == "mlp":
        cc.setdefault("params", {})["dropout"] = 0.0


REGIONS, FEATURE_DIM = 5, 16


def model_config(key, direct=False):
    """The model config of ``key`` as a plain dict, cut to the small
    size, f32, every classifier's dropout 0; ``direct``: over
    ``image_feature_0`` (``REGIONS`` regions of ``FEATURE_DIM``) through
    the ``identity`` feature encoder in place of ResNet-152."""
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.utils import flagship

    name = flagship.hateful_memes_model_name(key)
    cfg = flagship.hateful_memes_config(key)
    mc = omega.to_container(cfg["model_config"][name], resolve=True)
    mc["dtype"] = "float32"
    text = mc.get("text_encoder", {})
    if text.get("type") == "transformer":
        text["params"].update(SMALL_TEXT)
    elif text:
        text["params"]["embedding_params"]["params"]["vocab_size"] = VOCAB
    for key_ in ("classifier", "text_classifier", "modal_classifier"):
        _zero_classifier_dropout(mc.get(key_))
    if direct:
        mc["direct_features_input"] = True
        mc["modal_encoder"] = {"type": "identity",
                               "params": {"in_dim": FEATURE_DIM}}
        mc["num_features"] = REGIONS
        mc["modal_hidden_size"] = FEATURE_DIM
    return name, mc


def batch(seed=0, image=IMAGE):
    """Numpy inputs of every model: ragged BERT masks, two segments in
    one sample, 32 px images (``image``), vocabulary ids and binary
    targets."""
    rng = np.random.RandomState(seed)
    mask = np.ones((B, T), np.int32)
    mask[0, T - 4:] = 0
    mask[2, T - 2:] = 0
    segments = np.zeros((B, T), np.int32)
    segments[1, T // 2:] = 1
    return {
        "input_ids": rng.randint(1, VOCAB, (B, T)).astype(np.int32),
        "input_mask": mask,
        "segment_ids": segments,
        "image": rng.randn(B, 3, image, image).astype(np.float32),
        "text": rng.randint(0, VOCAB, (B, 14)).astype(np.int32),
        "targets": np.asarray([0, 1, 1, 0], np.int64),
        "image_feature_0": rng.randn(B, REGIONS, FEATURE_DIM).astype(
            np.float32),
    }


@contextlib.contextmanager
def x64():
    """JAX's float64 for the block, as it was after it."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _fill(shapes, seed, f64=False):
    rng = np.random.RandomState(seed)

    def visit(tree, path):
        value = draw(tree, path)
        if isinstance(value, dict):
            return value
        value = np.asarray(value, np.float32)
        return value.astype(np.float64) if f64 else value

    def draw(tree, path):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: visit(v, path + (k,)) for k, v in tree.items()}
        shape, leaf = tuple(tree.shape), path[-1]
        if path[0] == "batch_stats":
            return (0.1 * np.asarray(rng.randn(*shape)) if leaf == "mean"
                    else rng.uniform(0.5, 1.5, shape)).astype(np.float32)
        if leaf == "kernel" and len(shape) == 4:
            sd = np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        elif leaf == "kernel":
            sd = 1.0 / np.sqrt(shape[0])
        elif leaf == "embedding":
            sd = 0.02
        elif leaf == "scale" and path[-2] == "bn3":
            # each bottleneck's residual branch starts small (torchvision's
            # zero_init_residual, not quite zero): a deep ResNet in
            # training mode stays well conditioned
            return (0.1 + 0.01 * np.asarray(rng.randn(*shape))).astype(np.float32)
        elif leaf == "scale" or leaf.endswith("/scale"):
            return (1.0 + 0.1 * np.asarray(rng.randn(*shape))).astype(np.float32)
        else:
            sd = 0.1
        return (sd * np.asarray(rng.randn(*shape))).astype(np.float32)

    return {k: visit(v, (k,)) for k, v in shapes.items()}


def _port_f64(model):
    """Every weight, compute dtype and ``TransformerConfig`` dtype of the
    built port model to float64."""
    from mmf_tpu_torch.modules import transformer as T

    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
        if isinstance(getattr(m, "config", None), T.TransformerConfig):
            m.config = dataclasses.replace(m.config, dtype=torch.float64)
    return model


class Pair:
    """A model of ``key`` in JAX and in the port, the same weights; with
    ``f64``, in float64 on both sides: build and use it inside
    ``x64()``."""

    def __init__(self, key, seed=0, f64=False, direct=False, image=IMAGE):
        from mmf_tpu.common.registry import registry as jreg
        from mmf_tpu.config import omega as jomega
        from mmf_tpu.utils.env import setup_imports as jsetup
        from mmf_tpu_torch.common.registry import registry
        from mmf_tpu_torch.utils.env import setup_imports

        jsetup()
        setup_imports()
        self.name, mc = model_config(key, direct)
        if f64:
            mc["dtype"] = "float64"
            if mc.get("text_encoder", {}).get("type") == "transformer":
                mc["text_encoder"]["params"]["dtype"] = "float64"
        self.config = mc
        self.batch = batch(seed, image)
        if f64:
            for k in ("image", "image_feature_0"):
                self.batch[k] = self.batch[k].astype(np.float64)
        self.jm = jreg.get_model_class(self.name)(config=jomega.create(mc))
        jb = self.jax_batch(self.batch)
        shapes = jax.eval_shape(
            lambda: self.jm.init(jax.random.PRNGKey(0), jb, False))
        self.variables = _fill(shapes, seed + 1, f64)
        # the port's configs name no float64: built in float32, converted
        port_mc = copy.deepcopy(mc)
        if "dtype" in port_mc:
            port_mc["dtype"] = "float32"
        self.tm = registry.get_model_class(self.name)(config=port_mc)
        if f64:
            _port_f64(self.tm)
        self.tm.load_state_dict(self.state_dict(self.variables), strict=True)
        self.tm.eval()

    @staticmethod
    def jax_batch(b):
        return dict({k: jnp.asarray(v) for k, v in b.items()}, **META)

    @staticmethod
    def port_batch(b):
        return dict({k: torch.from_numpy(v) for k, v in b.items()}, **META)

    @staticmethod
    def state_dict(variables):
        return params_from_jax(jax.device_get(variables.get("params", {})),
                               jax.device_get(variables.get("batch_stats")))

    def forwards(self):
        jb = self.jax_batch(self.batch)
        want = jax.jit(lambda v: self.jm.apply(v, jb, False))(
            self.variables)["scores"]
        with torch.no_grad():
            got = self.tm.eval()(self.port_batch(self.batch))["scores"]
        return got.numpy(), np.asarray(want)


def jax_no_dropout(package="mmf_tpu"):
    """A patch that builds every ``TransformerConfig`` of ``package``
    (``mmf_tpu`` or ``mmf_tpu_torch``) at dropout 0 (the text encoders
    read no rate from the config): use with
    ``pytest.MonkeyPatch.context()``."""
    import importlib

    TransformerConfig = importlib.import_module(
        f"{package}.modules.transformer").TransformerConfig
    init = TransformerConfig.__init__

    def zero(self, *args, **kwargs):
        init(self, *args, **kwargs)
        object.__setattr__(self, "hidden_dropout_prob", 0.0)
        object.__setattr__(self, "attention_probs_dropout_prob", 0.0)

    return TransformerConfig, "__init__", zero


def port_no_dropout(model):
    """Every dropout rate of the built port model to 0."""
    from mmf_tpu_torch.modules import transformer as T

    for m in model.modules():
        if isinstance(getattr(m, "config", None), T.TransformerConfig):
            m.config = dataclasses.replace(
                m.config, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
        if isinstance(m, T.Dropout):
            m.rate = 0.0
    return model


def rel_err(a, b, floor=1e-8):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              floor)


def train_both(pair, steps=4):
    """Step-0 gradients and a ``steps``-step AdamW trajectory on both
    sides, from the pair's weights, in training mode (the BatchNorm
    statistics move). Returns a dict: ``grads`` (JAX's and the port's by
    port name), ``losses`` (two lists), ``jax_state`` (JAX's final
    state_dict) and the port model."""
    import optax

    from mmf_tpu.config import omega as jomega
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu.modules.optimizers import build_optimizer_transform
    from mmf_tpu.modules.schedulers import build_scheduler as j_scheduler
    from mmf_tpu_torch.config import omega as tomega
    from mmf_tpu_torch.modules.optimizers import build_optimizer
    from mmf_tpu_torch.modules.schedulers import (
        build_lr_scheduler,
        build_scheduler,
    )
    from mmf_tpu_torch.trainers.core import train_state as tts

    jm = pair.jm
    jb = pair.jax_batch(pair.batch)
    losses_fn = JLosses(pair.config["losses"])
    mutable = ["batch_stats"] if "batch_stats" in pair.variables else False

    def loss(params, stats):
        variables = {"params": params, **stats}
        out = jm.apply(variables, jb, True,
                       rngs={"dropout": jax.random.PRNGKey(0)},
                       mutable=mutable)
        out, new = out if mutable else (out, {})
        total = sum(jnp.mean(v) for v in losses_fn(jb, out).values())
        return total, dict(new)

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    jcfg = jomega.create(TRAIN_CONFIG)
    tx = build_optimizer_transform(
        jcfg, schedule_fn=j_scheduler(jcfg),
        weight_decay_mask=jm.get_weight_decay_mask(jcfg))
    params = pair.variables["params"]
    stats = {k: v for k, v in pair.variables.items() if k != "params"}
    opt_state = tx.init(params)
    update = jax.jit(tx.update)

    tm = port_no_dropout(pair.tm)
    probe = copy.deepcopy(tm).train()
    out = probe(pair.port_batch(pair.batch))
    sum(v.mean() for v in probe.build_losses()(
        pair.port_batch(pair.batch), out).values()).backward()
    port_grads = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
                  else p.grad.numpy() for n, p in probe.named_parameters()}

    tcfg = tomega.create(TRAIN_CONFIG)
    opt = build_optimizer(tcfg, tm,
                          weight_decay_mask=tm.get_weight_decay_mask(tcfg))
    step = tts.make_train_step(tm.build_losses(), meta=META)
    state = tts.create_train_state(
        tm, opt, seed=1,
        lr_scheduler=build_lr_scheduler(opt, build_scheduler(tcfg)))
    j_losses, t_losses, jax_grads = [], [], None
    for _ in range(steps):
        (value, stats), grads = grad_fn(params, stats)
        if jax_grads is None:
            jax_grads = {k: v.numpy() for k, v in params_from_jax(
                jax.device_get(grads)).items()}
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(value))
        state, report = step(state, pair.batch)
        t_losses.append(float(report["total_loss"]))
    return {"grads": (jax_grads, port_grads),
            "losses": (j_losses, t_losses),
            "jax_state": pair.state_dict({"params": params, **stats}),
            "model": state.model}


LOSS_RTOL = 2e-4  # tests/test_torch_train_step.py's trajectory bound
STATS_REL = 1e-4
WEIGHT_REL = 1e-3
FLIPPED = 0.01
# the sum of the schedule's learning rates over the 4 steps (warmup 2 of
# 10, linear decay): no Adam step moves a weight by more than its lr
# (plus the decay's share)
LR_SUM = 1e-3 * (0.0 + 0.5 + 1.0 + 7.0 / 8.0)


def assert_trajectory(trained, steps=4):
    """Losses within ``LOSS_RTOL``; the BatchNorm statistics within
    ``STATS_REL`` of the largest; every weight within ``WEIGHT_REL`` of
    its tensor's largest but for at most ``FLIPPED`` of its elements,
    and those within twice the steps' learning rates: Adam moves a
    weight by about its lr whatever the gradient's size, so a gradient
    within f32 noise of 0 (the attention and LayerNorm compute in f32 on
    both sides) may step either way. The key biases' gradients are such
    noise throughout (softmax is shift-invariant along keys) and are
    left out, as in tests/test_torch_train_step.py."""
    j_losses, t_losses = trained["losses"]
    assert len(t_losses) == steps and all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    want = trained["jax_state"]
    got = trained["model"].state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        if name.endswith("num_batches_tracked") or name.endswith(
                "key.bias"):
            continue
        ours, theirs = got[name].double().numpy(), value.double().numpy()
        if name.endswith(("running_mean", "running_var")):
            err = rel_err(ours, theirs)
            assert err < STATS_REL, f"{name} after {steps} steps: {err:.2e}"
            continue
        diff = np.abs(ours - theirs)
        off = diff > WEIGHT_REL * np.abs(theirs).max()
        assert off.mean() <= FLIPPED, \
            f"{name}: {off.mean():.2%} of the weights off after {steps} steps"
        assert diff.max() <= 2 * LR_SUM, \
            f"{name}: a weight off by {diff.max():.2e} after {steps} steps"
