"""The port's losses, lr schedules, optimizer translation and parameter
groups against the JAX package, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmf_tpu.config import omega as jomega
from mmf_tpu.modules import losses as jlosses
from mmf_tpu.modules import optimizers as joptim
from mmf_tpu.modules import schedulers as jsched
from mmf_tpu_torch.config import omega as tomega
from mmf_tpu_torch.modules import losses as tlosses
from mmf_tpu_torch.modules import optimizers as toptim
from mmf_tpu_torch.modules import schedulers as tsched
from mmf_tpu_torch.utils import general as tgeneral
from mmf_tpu_torch.utils import modeling as tmodeling
from tests.torch_port_utils import TINY, init_pair, tiny_batch

torch.set_num_threads(2)  # several test workers share the host


def _loss_inputs(name):
    rng = np.random.RandomState(0)
    scores = (rng.randn(5, 7) * 3).astype(np.float32)
    if name == "logit_bce":
        targets = (rng.rand(5, 7) > 0.7).astype(np.float32) * rng.rand(5, 7)
        return scores, targets.astype(np.float32)
    targets = rng.randint(0, 7, size=5).astype(np.int32)
    targets[2] = -100  # ignore_index
    return scores, targets


@pytest.mark.parametrize("name", ["logit_bce", "cross_entropy"])
def test_losses_match_jax_with_keys(name):
    scores, targets = _loss_inputs(name)
    meta = {"dataset_name": "vqa2", "dataset_type": "train"}
    want = jlosses.Losses([{"type": name}])(
        dict(meta, targets=jnp.asarray(targets)),
        {"scores": jnp.asarray(scores)})
    got = tlosses.Losses([{"type": name}])(
        dict(meta, targets=torch.from_numpy(targets)),
        {"scores": torch.from_numpy(scores)})
    assert list(got) == list(want) == [f"train/vqa2/{name}"]
    np.testing.assert_allclose(got[f"train/vqa2/{name}"].numpy(),
                               np.asarray(want[f"train/vqa2/{name}"]),
                               rtol=1e-6)


def test_sigmoid_bce_matches_jax_elementwise():
    scores, targets = _loss_inputs("logit_bce")
    np.testing.assert_allclose(
        tlosses.sigmoid_bce_with_logits(torch.from_numpy(scores),
                                        torch.from_numpy(targets)).numpy(),
        np.asarray(jlosses.sigmoid_bce_with_logits(jnp.asarray(scores),
                                                   jnp.asarray(targets))),
        rtol=1e-6, atol=1e-7)


SCHEDULES = {
    "pythia": {"training": {"use_warmup": True, "warmup_iterations": 4,
                            "warmup_factor": 0.25, "lr_steps": [6, 9],
                            "lr_ratio": 0.5, "max_updates": 12}},
    "warmup_linear": {"training": {"max_updates": 12},
                      "params": {"num_warmup_steps": 3}},
    "warmup_cosine": {"training": {"max_updates": 12},
                      "params": {"num_warmup_steps": 3,
                                 "num_training_steps": 10}},
    "multi_step": {"training": {"max_updates": 12},
                   "params": {"lr_steps": [2, 7], "lr_ratio": 0.3,
                              "use_warmup": True, "warmup_iterations": 2,
                              "warmup_factor": 0.1}},
}


@pytest.mark.parametrize("stype", sorted(SCHEDULES))
def test_schedules_match_jax(stype):
    spec = SCHEDULES[stype]
    config = {"training": dict(spec["training"], lr_scheduler=True),
              "scheduler": {"type": stype, "params": spec.get("params", {})}}
    want = jsched.build_scheduler(jomega.create(config))
    got = tsched.build_scheduler(tomega.create(config))
    for step in range(14):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-7, err_msg=f"step {step}")


def test_lr_scheduler_applies_the_schedule_from_update_zero():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.SGD([p], lr=2.0)
    sched = tsched.build_lr_scheduler(opt, lambda s: 0.5 ** s)
    seen = []
    for _ in range(3):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert seen == [2.0, 1.0, 0.5]


def test_clip_gradients_config_and_global_norm_clip():
    cfg = tomega.create({"training": {"clip_gradients": True,
                                      "max_grad_l2_norm": 0.25}})
    assert tgeneral.clip_gradients_config(cfg) == 0.25
    assert tgeneral.clip_gradients_config(tomega.create(
        {"training": {"clip_gradients": False,
                      "max_grad_l2_norm": 0.25}})) is None
    rng = np.random.RandomState(1)
    grads = [rng.randn(4, 3).astype(np.float32),
             rng.randn(5).astype(np.float32)]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    for max_norm in (0.25, 100.0):  # clipped, and left alone
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        toptim.clip_grad_norm(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


def _flax_to_port_names(tree, prefix=()):
    leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight",
            "bias": "bias"}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flax_to_port_names(v, prefix + (k,)))
        else:
            out[".".join(prefix + (leaf[k],))] = v
    return out


@pytest.mark.parametrize("rule", ["bert_no_decay_mask",
                                  "get_bert_configured_parameters"])
def test_weight_decay_masks_match_jax(rule):
    from mmf_tpu.utils import modeling as jmodeling

    batch = tiny_batch(2)
    jm, variables, tm = init_pair(dict(TINY), batch)
    params = jax.device_get(variables["params"])
    if rule == "bert_no_decay_mask":
        want = jm.get_weight_decay_mask()(params)
        got = tm.get_weight_decay_mask()(tm)
    else:
        want = jmodeling.get_bert_configured_parameters(params)
        got = tmodeling.get_bert_configured_parameters(tm)
    want = {k: bool(v) for k, v in _flax_to_port_names(want).items()}
    assert got == want
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("finetune_lr_multiplier", [1, 0.1])
def test_optimizer_parameters_for_bert_match_jax(finetune_lr_multiplier):
    from mmf_tpu.utils import modeling as jmodeling

    batch = tiny_batch(2)
    _, variables, tm = init_pair(dict(TINY), batch)
    params = jax.device_get(variables["params"])
    config = {"model": "visual_bert", "model_config": {"visual_bert": {
        "finetune_lr_multiplier": finetune_lr_multiplier}}}
    want_mask, want_tx = jmodeling.get_optimizer_parameters_for_bert(
        params, jomega.create(config))
    got_mask, got_scales = tmodeling.get_optimizer_parameters_for_bert(
        tm, tomega.create(config))
    assert got_mask == {k: bool(v) for k, v in
                        _flax_to_port_names(want_mask).items()}
    if finetune_lr_multiplier == 1:
        assert want_tx is None and got_scales is None
        return
    # JAX keeps the scales as f32 arrays
    want = {k: np.float32(v) for k, v in
            _flax_to_port_names(want_tx.init(params)).items()}
    got = tmodeling.lr_multiplier_labels(tm, got_scales)
    assert {k: np.float32(v) for k, v in got.items()} == want
    assert set(got.values()) == {0.1, 1.0}


def test_optimizer_groups_and_translation():
    batch = tiny_batch(2)
    _, _, tm = init_pair(dict(TINY), batch)
    cfg = tomega.create({"optimizer": {"type": "adam_w", "params": {
        "lr": "5e-05", "eps": 1e-8, "betas": [0.8, 0.99]}}})
    opt = toptim.build_optimizer(
        cfg, tm, lr_multipliers={"": 0.5, "classifier": 1.0},
        weight_decay_mask=tm.get_weight_decay_mask())
    assert isinstance(opt, torch.optim.AdamW)
    mask = tm.get_weight_decay_mask()(tm)
    seen = set()
    for group in opt.param_groups:
        scale = 1.0 if group["names"][0].startswith("classifier") else 0.5
        assert group["lr"] == pytest.approx(5e-5 * scale)
        assert group["betas"] == (0.8, 0.99) and group["eps"] == 1e-8
        for name in group["names"]:
            assert name.startswith("classifier") == (scale == 1.0)
            # adam_w defaults weight_decay to 0.01, off for no-decay names
            assert group["weight_decay"] == (0.01 if mask[name] else 0.0)
            seen.add(name)
    assert seen == {n for n, _ in tm.named_parameters()}


def test_adam_w_skip_params_with_zero_grad_matches_jax():
    rng = np.random.RandomState(2)
    w0 = rng.randn(3, 2).astype(np.float32)
    b0 = rng.randn(2).astype(np.float32)
    grads = [(rng.randn(3, 2).astype(np.float32),
              np.zeros(2, np.float32)),
             (rng.randn(3, 2).astype(np.float32),
              rng.randn(2).astype(np.float32)),
             (np.zeros((3, 2), np.float32),
              rng.randn(2).astype(np.float32))]
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    tx = joptim.adam_w_skip_params_with_zero_grad(
        learning_rate=1e-2, weight_decay=0.1)
    state = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    b = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    cfg = tomega.create({"optimizer": {
        "type": "adam_w_skip_params_with_zero_grad",
        "params": {"lr": 1e-2, "weight_decay": 0.1}}})
    module = torch.nn.Module()
    module.w, module.b = w, b
    opt = toptim.build_optimizer(cfg, module)
    for gw, gb in grads:
        updates, state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(
            gb)}, state, params)
        params = optax.apply_updates(params, updates)
        w.grad, b.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), params["w"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(b.detach().numpy(), params["b"],
                                   rtol=1e-5, atol=1e-7)
