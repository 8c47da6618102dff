"""Shared helpers of the Pythia, BUTD, LoRRA and BAN parity tests
(``tests/test_torch_{pythia,butd,multihead,lorra,ban}.py``): the models
built in JAX and in the port from their default YAML at small widths,
the JAX init carried across by ``params_from_jax``, seeded numpy inputs,
and the 4-step trajectory of the configs' optimizer: Adamax with the
warmup ``multi_step`` schedule and global-norm clipping at 0.25."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import tree_map

# the configs' optimizer and schedule (projects/butd/configs/coco/
# defaults.yaml; Pythia's VQA2 config gives the same through the
# training keys), the warmup cut to 3 iterations so that 4 steps cross it
TRAIN_CONFIG = {
    "training": {"lr_scheduler": True, "max_updates": 10,
                 "clip_gradients": True, "clip_norm_mode": "all",
                 "max_grad_l2_norm": 0.25},
    "optimizer": {"type": "Adamax", "params": {"lr": 0.01, "eps": 1e-8}},
    "scheduler": {"type": "multi_step",
                  "params": {"use_warmup": True, "lr_steps": [3],
                             "lr_ratio": 0.1, "warmup_iterations": 2,
                             "warmup_factor": 0.2}},
}
TRAJ_RTOL = 1e-5


def model_config(package, name, overrides):
    """``name``'s model config from its default YAML (the Pythia
    ablations share ``pythia``'s), ``overrides`` set at the top."""
    if package == "jax":
        from mmf_tpu.config.configuration import load_yaml
        from mmf_tpu.utils.env import setup_imports
    else:
        from mmf_tpu_torch.config.configuration import load_yaml
        from mmf_tpu_torch.utils.env import setup_imports
    setup_imports()
    # multihead has no YAML of its own: the runs give it Pythia's
    folder = "pythia" if name.startswith("pythia") or name == "multihead" \
        else name
    mcs = load_yaml(f"configs/models/{folder}/defaults.yaml")["model_config"]
    mc = mcs[name] if name in mcs else mcs[folder]
    for key, value in overrides.items():
        mc[key] = value
    return mc


def build(package, name, overrides):
    if package == "jax":
        from mmf_tpu.common.registry import registry
    else:
        from mmf_tpu_torch.common.registry import registry
    mc = model_config(package, name, overrides)
    return registry.get_model_class(name)(config=mc)


def pair(name, overrides, batch, seed=0):
    """The JAX model and its variables, and the port model holding the
    same weights (eval mode)."""
    jm = build("jax", name, overrides)
    variables = jax.device_get(
        jm.init(jax.random.PRNGKey(seed), tree_map(jnp.asarray, batch),
                False))
    tm = build("port", name, overrides)
    tm.load_state_dict(params_from_jax(variables["params"]), strict=True)
    return jm, variables, tm.eval()


def rel_err(a, b, floor=1e-8):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              floor)


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    den = np.linalg.norm(a) * np.linalg.norm(b)
    return 1.0 if den == 0 else float(a @ b / den)


def losses_pair(names):
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu_torch.modules.losses import Losses

    return JLosses(list(names)), Losses(list(names))


def grads(jm, variables, tm, batch, jax_batch, loss_names):
    """JAX's and the port's step-0 gradients (by port name) of the summed
    losses, in training mode at dropout 0 (the configs' rates set to 0
    by the caller). ``jax_batch`` is what JAX's loss reads (BUTD's
    targets, which JAX's model does not add)."""
    jlosses, tlosses = losses_pair(loss_names)
    jb = tree_map(jnp.asarray, jax_batch)

    def loss(params):
        out = jm.apply({"params": params}, jb, True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.mean(v) for v in jlosses(jb, out).values())

    want = {k: v.numpy() for k, v in params_from_jax(jax.device_get(
        jax.jit(jax.grad(loss))(variables["params"]))).items()}
    tm.train()
    tb = tree_map(torch.from_numpy, batch)
    out = tm(tb)
    sum(v.mean() for v in tlosses(tb, out).values()).backward()
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return want, got


def trajectory(jm, variables, tm, batch, jax_batch, loss_names, steps=4,
               f64=False, train_config=None):
    """``steps`` updates of ``train_config`` (``TRAIN_CONFIG`` by default)
    on both sides from the same weights: (JAX's losses, the port's, JAX's
    final params by port name).
    With ``f64`` both sides run in float64 (JAX with x64 on for the
    call), so that f32 rounding, which Adamax's normalised step turns
    into moves of the order of the learning rate where a gradient is
    small, stays out of the comparison."""
    if f64:
        from tests.torch_hm_models import _port_f64, x64

        def wide(tree):
            return tree_map(lambda a: a.astype(np.float64) if np.asarray(
                a).dtype == np.float32 else a, tree)

        with x64():
            variables = {"params": jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables["params"])}
            return trajectory(jm, variables, _port_f64(tm), wide(batch),
                              wide(jax_batch), loss_names, steps,
                              train_config=train_config)
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

    train_config = train_config or TRAIN_CONFIG
    training = train_config["training"]
    clip = training.get("max_grad_l2_norm", 0.25) if training.get(
        "clip_gradients", False) else None
    jlosses, tlosses = losses_pair(loss_names)
    jcfg = jomega.create(train_config)
    tx = build_optimizer_transform(jcfg, schedule_fn=j_scheduler(jcfg),
                                   max_grad_norm=clip)
    jstep = jax.jit(jts.make_train_step(jm.apply, jlosses, tx))
    jstate = jts.create_train_state({"params": variables["params"]}, tx,
                                    jax.random.PRNGKey(1))
    tcfg = tomega.create(train_config)
    opt = build_optimizer(tcfg, tm)
    tstep = tts.make_train_step(tlosses,
                                max_grad_norm=clip_gradients_config(tcfg))
    tstate = tts.create_train_state(
        tm, opt, seed=1,
        lr_scheduler=build_lr_scheduler(opt, build_scheduler(tcfg)))
    jbatch = tree_map(jnp.asarray, jax_batch)
    j_losses, t_losses = [], []
    for _ in range(steps):
        jstate, jrep = jstep(jstate, jbatch)
        tstate, trep = tstep(tstate, tree_map(torch.from_numpy, batch))
        j_losses.append(float(jrep["total_loss"]))
        t_losses.append(float(trep["total_loss"]))
    want = params_from_jax(jax.device_get(jstate.variables["params"]))
    return j_losses, t_losses, want


def init_shapes(module, *args, **kwargs):
    """The shapes of ``module.init(*args, **kwargs)``'s variables, which
    is all ``randomize`` reads (flax's initialisers, run eagerly, cost
    seconds a model)."""
    return jax.eval_shape(lambda: module.init(*args, **kwargs))


def randomize(variables, seed: int = 0):
    """The JAX init's params redrawn from a numpy seed, so that no layer
    sits at flax's zero biases or unit gains (a zeroed text arm would
    score 0 on both sides): kernels ~ N(0, 1/fan_in), tables N(0, 1),
    biases N(0, 0.1), weight-norm gains 1 + N(0, 0.2)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(leaf)
        if name.endswith("/kernel/scale"):
            value = 1.0 + 0.2 * rng.randn(*shape)
        elif name == "kernel":
            fan_in = int(np.prod(shape[:-1])) or 1
            value = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "embedding":
            value = rng.randn(*shape)
        else:
            value = 0.1 * rng.randn(*shape)
        return np.asarray(value, np.float32)

    return {"params": jax.tree_util.tree_map_with_path(
        draw, jax.device_get(variables["params"]))}


def load(tm, variables):
    tm.load_state_dict(params_from_jax(variables["params"]), strict=True)
    return tm.eval()


def assert_round_trip(variables, tm):
    """The port's state_dict through JAX's ``convert_torch_state_dict``
    with no key map: every flax leaf matched, none missed, bit-equal."""
    from mmf_tpu.utils.checkpoint_updater import (
        _flatten_flax,
        convert_torch_state_dict,
    )

    params = jax.device_get(variables["params"])
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    converted, stats = convert_torch_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}, zeros)
    want, got = _flatten_flax(params), _flatten_flax(converted)
    assert stats == {"matched": len(want), "missed": 0, "shape_mismatch": 0}
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(want[path]),
                                      err_msg="/".join(path))


def assert_grads_match(want, got, min_cosine=0.99999):
    """Every parameter's gradient at cosine >= ``min_cosine``; one whose
    gradient is 0 in exact arithmetic (a bias under a softmax's shift
    invariance) holds f32 noise on both sides, below 1e-6 of the largest
    gradient's norm, which is what it is held to."""
    assert got.keys() == want.keys()
    norms = {k: float(np.linalg.norm(v)) for k, v in want.items()}
    floor = 1e-6 * max(norms.values())
    for key in want:
        if norms[key] < floor:
            assert float(np.linalg.norm(got[key])) < floor, key
            continue
        c = cosine(got[key], want[key])
        assert c >= min_cosine, f"{key}: cosine {c}"


# the biases under a softmax over the regions (the attention's raw score,
# the multi-head attention's key projection) or over time (the text
# attention's maps): their gradient is 0 in exact arithmetic, f32 noise on
# both sides that Adamax's normalised step turns into moves of the order
# of the learning rate
SHIFT_INVARIANT = ("transform.module.Dense_0.bias", "conv2.bias",
                   "step.Dense_0.bias", "k_proj.bias")


def assert_params_match(tm, want, rtol=TRAJ_RTOL, skip=SHIFT_INVARIANT):
    for key, p in tm.named_parameters():
        if skip and key.endswith(skip):
            continue
        err = rel_err(p.detach().numpy(), want[key].numpy())
        assert err < rtol, f"{key}: {err:.2e}"
