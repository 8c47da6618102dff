"""Shared helpers of the UNITER, LXMERT and VinVL parity tests
(``tests/test_torch_{uniter,lxmert,vinvl}.py``): a model built in JAX and
in the port from ``configs/models/<name>/defaults.yaml`` with the same
overrides, the JAX init carried across by ``params_from_jax``, and the
same numpy inputs through both; the step-0 gradients, a 4-step AdamW
trajectory and the weights' round trip through JAX's
``convert_torch_state_dict``. The bars are the repo's: f32 outputs atol
2e-5, losses rtol 1e-5, gradients relative 5e-4 over a floor of 1e-3 of
the global scale, trajectory losses rtol 2e-4 and parameters relative
1e-3 (``tests/test_torch_train_step.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.test_torch_vilt import port_no_dropout
from tests.torch_port_utils import cached_init, tree_map

ATOL, LOSS_RTOL = 2e-5, 1e-5
GRAD_RTOL, TRAJ_LOSS_RTOL, TRAJ_PARAM_RTOL = 5e-4, 2e-4, 1e-3

TRAIN_CONFIG = {
    "training": {"lr_scheduler": True, "max_updates": 10,
                 "clip_gradients": True, "max_grad_l2_norm": 0.5},
    "optimizer": {"type": "adam_w",
                  "params": {"lr": 1e-3, "eps": 1e-8, "weight_decay": 0.01}},
    "scheduler": {"type": "warmup_linear",
                  "params": {"num_warmup_steps": 2,
                             "num_training_steps": 10}},
}


def model(package, name, overrides):
    """``name``'s model of ``package`` ("jax" or "port") from its default
    YAML with ``overrides`` set at the top of its model config."""
    if package == "jax":
        from mmf_tpu.common.registry import registry
        from mmf_tpu.config.configuration import load_yaml
        from mmf_tpu.utils.env import setup_imports
    else:
        from mmf_tpu_torch.common.registry import registry
        from mmf_tpu_torch.config.configuration import load_yaml
        from mmf_tpu_torch.utils.env import setup_imports
    setup_imports()
    mc = load_yaml(f"configs/models/{name}/defaults.yaml")["model_config"][
        name]
    mc.update(overrides)
    return registry.get_model_class(name)(config=mc)


def pair(name, overrides, batch, meta, seed=0):
    """The JAX model and its variables, and the port model holding the
    same weights (eval mode), sized by the batch where flax sizes a
    layer from the data."""
    jm = model("jax", name, overrides)
    # an init with no task runs every task, so that every head is built
    init_meta = {k: v for k, v in meta.items() if k != "task"}
    jb = dict(tree_map(jnp.asarray, batch), **init_meta)
    variables = cached_init(jm, jax.random.PRNGKey(seed), jb, False)
    tm = model("port", name, overrides)
    if tm.has_uninitialized_params():
        tm.materialize(tree_map(torch.from_numpy, batch))
    tm.load_state_dict(params_from_jax(jax.device_get(variables["params"])),
                       strict=True)
    return jm, variables, tm.eval()


def jax_out(jm, variables, batch, meta):
    return jm.apply(variables, dict(tree_map(jnp.asarray, batch), **meta),
                    False)


def port_out(tm, batch, meta):
    with torch.no_grad():
        return tm.eval()(dict(tree_map(torch.from_numpy, batch), **meta))


def assert_outputs_match(want, got, keys=("scores",)):
    """The outputs named in ``keys`` within atol 2e-5 and every loss
    within rtol 1e-5, the loss names equal and in the same order."""
    for key in keys:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert list(got.get("losses", {})) == list(want.get("losses", {}))
    for key, value in want.get("losses", {}).items():
        np.testing.assert_allclose(float(got["losses"][key]), float(value),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)


def rel_err(a, b, floor=1e-8):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              floor)


def losses_pair(names):
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu_torch.modules.losses import Losses

    return JLosses(list(names)), Losses(list(names))


def grads(name, overrides, batch, meta, loss_names=()):
    """JAX's and the port's step-0 gradients (by port name) of the summed
    losses, the model's own and ``loss_names``'. The JAX side must build
    its configs at dropout 0 (``jax_no_dropout``)."""
    jm, variables, tm = pair(name, overrides, batch, meta)
    jlosses, tlosses = losses_pair(loss_names)
    jb = dict(tree_map(jnp.asarray, batch), **meta)

    def loss(params):
        out = jm.apply({"params": params}, jb, True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        values = dict(out.get("losses", {}), **jlosses(jb, out))
        return sum(jnp.mean(v) for v in values.values())

    want = {k: v.numpy() for k, v in params_from_jax(jax.device_get(
        jax.jit(jax.grad(loss))(variables["params"]))).items()}
    port_no_dropout(tm).train()
    tb = dict(tree_map(torch.from_numpy, batch), **meta)
    out = tm(tb)
    values = dict(out.get("losses", {}), **tlosses(tb, out))
    sum(v.mean() for v in values.values()).backward()
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tm.named_parameters()}
    return want, got


def assert_grads_match(want, got):
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for key in want:
        err = rel_err(got[key], want[key], floor)
        assert err < GRAD_RTOL, f"gradient mismatch at {key}: rel {err:.2e}"


def trajectory(name, overrides, batch, meta, loss_names=(), steps=4):
    """``steps`` AdamW steps (warmup, weight decay, clipping, the model's
    weight-decay mask and lr multipliers) on both sides from the same
    weights at dropout 0 (the JAX side through ``jax_no_dropout``): the
    losses within rtol 2e-4 and every parameter within 1e-3 relative."""
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

    jm, variables, tm = pair(name, overrides, batch, meta)
    port_no_dropout(tm)
    jlosses, tlosses = losses_pair(loss_names)
    jcfg = jomega.create(TRAIN_CONFIG)
    tx = build_optimizer_transform(
        jcfg, schedule_fn=j_scheduler(jcfg), max_grad_norm=0.5,
        weight_decay_mask=jm.get_weight_decay_mask(jcfg),
        lr_multipliers=jm.get_lr_multipliers(jcfg))
    jstep = jax.jit(jts.make_train_step(jm.apply, jlosses, tx, meta=meta))
    jstate = jts.create_train_state({"params": variables["params"]}, tx,
                                    jax.random.PRNGKey(1))
    tcfg = tomega.create(TRAIN_CONFIG)
    opt = build_optimizer(tcfg, tm,
                          lr_multipliers=tm.get_lr_multipliers(tcfg),
                          weight_decay_mask=tm.get_weight_decay_mask(tcfg))
    tstep = tts.make_train_step(
        tlosses, max_grad_norm=clip_gradients_config(tcfg), meta=meta)
    tstate = tts.create_train_state(
        tm, opt, seed=1,
        lr_scheduler=build_lr_scheduler(opt, build_scheduler(tcfg)))
    jbatch = tree_map(jnp.asarray, batch)
    j_losses, t_losses = [], []
    for _ in range(steps):
        jstate, jrep = jstep(jstate, jbatch)
        tstate, trep = tstep(tstate, batch)
        j_losses.append(float(jrep["total_loss"]))
        t_losses.append(float(trep["total_loss"]))
        assert sorted(trep["losses"]) == sorted(jrep["losses"])
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_LOSS_RTOL,
                               err_msg=f"jax {j_losses}\nport {t_losses}")
    # the weights moved at each step after the first (the schedule's
    # warmup starts at lr 0)
    assert len(set(t_losses)) == steps - 1
    want = params_from_jax(jax.device_get(jstate.variables["params"]))
    for key, p in tm.named_parameters():
        if key.endswith("key.bias"):
            # softmax is shift-invariant along the keys: f32 noise on both
            # sides that Adam scales up (tests/test_torch_train_step.py)
            continue
        err = rel_err(p.detach().numpy(), want[key].numpy())
        assert err < TRAJ_PARAM_RTOL, f"weights differ at {key}: {err:.2e}"
    return t_losses


def assert_round_trip(variables, tm):
    """The port's state_dict through JAX's ``convert_torch_state_dict``:
    every flax leaf matched, none missed, the arrays bit-equal."""
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
    assert set(want) == set(got)
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(want[path]),
                                      err_msg="/".join(path))
