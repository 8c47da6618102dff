"""The M4C captioner in the port against the JAX package on the CPU.

``test_torch_m4c``'s small M4C (TextBert 2 x 32, MMT 2 x 32, the fc7
layers at their real 2048, 12 decode steps, 40 answers, f32, dropout 0)
built from ``configs/models/m4c_captioner/defaults.yaml``, initialised
in JAX and carried across by ``params_from_jax``; ``<unk>`` (index 3)
comes from the ``textcaps_answer_processor`` in both registries, as a
TextCaps builder registers it.

- The teacher-forced scores within 2e-5, with the ``<unk>`` column at
  -1e10 at every step; the greedy decode's scores within 2e-5 and its
  tokens equal at every step (each step's top-2 margin in JAX's scores
  at least 10x the tolerance), ``<unk>`` never among them.
- The loss rtol 1e-5 on a batch with no ``<unk>`` target and on one
  with such targets, where the -1e10 logit adds 1e10 a target to the
  BCE sum (in both packages); step-0 gradients relative 5e-4 over a
  floor of 1e-3 of the largest, the same on both batches (the masked
  column passes no gradient).
- A 4-step Adam trajectory with the lr multipliers and the warmup
  multi-step schedule: losses rtol 2e-4, parameters relative 1e-3.
- ``<unk>``'s index resolved as JAX resolves it: ``unk_idx``, else the
  first dataset's answer processor, else nothing masked;
  ``remove_unk_in_pred: false`` masks nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.test_torch_m4c import (
    ANSWERS,
    ATOL,
    B,
    DEC,
    OCR,
    TRAIN_CONFIG,
    make_batch,
)
from tests.test_torch_m4c import model_config as m4c_model_config
from tests.torch_port_utils import registries_restored, tree_map

torch.set_num_threads(2)  # several test workers share the host

UNK = 3
META = {"dataset_name": "textcaps", "dataset_type": "train"}


class _AnswerProcessor:
    UNK_IDX = UNK


def model_config(**extra):
    from mmf_tpu.config.configuration import load_yaml

    mc = load_yaml("configs/models/m4c_captioner/defaults.yaml")[
        "model_config"]["m4c_captioner"]
    small = m4c_model_config()
    for key in ("text_bert", "mmt", "obj", "ocr", "classifier"):
        mc[key] = small[key]
    mc["datasets"] = "textcaps"
    assert mc["remove_unk_in_pred"]
    mc.update(extra)
    return mc


def _batches():
    """(a batch with no <unk> target, one with <unk> targets)."""
    clean = make_batch(seed=3)
    clean["targets"][..., UNK] = 0.0
    with_unk = make_batch(seed=3)
    with_unk["targets"][:, :4, UNK] = 1.0
    return clean, with_unk


@pytest.fixture(scope="module")
def pair():
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.utils.env import setup_imports as jax_imports
    from mmf_tpu_torch.common.registry import registry as preg
    from mmf_tpu_torch.models.m4c_captioner import M4CCaptioner

    jax_imports()
    with registries_restored():
        for reg in (jreg, preg):
            reg.register("textcaps_num_final_outputs", ANSWERS + OCR)
            reg.register("textcaps_answer_processor", _AnswerProcessor())
        jm = jreg.get_model_class("m4c_captioner")(config=model_config())
        batch = make_batch()
        variables = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              False))(
            tree_map(jnp.asarray, batch))
        tm = M4CCaptioner(model_config())
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


def test_teacher_forced_scores_match_jax_with_unk_masked(pair):
    want = np.asarray(pair["jax_train"](
        pair["variables"], tree_map(jnp.asarray, pair["batch"])))
    tm = pair["tm"].train()
    with torch.no_grad():
        got = tm(_port(pair["batch"]))["scores"].numpy()
    assert got.shape == (B, DEC, ANSWERS + OCR)
    assert (got[..., UNK] == -1e10).all() and (want[..., UNK] == -1e10).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_greedy_decode_matches_jax_token_for_token(pair):
    want = np.asarray(pair["jax_eval"](
        pair["variables"], tree_map(jnp.asarray, pair["batch"])))
    tm = pair["tm"].eval()
    with torch.no_grad():
        got = tm(_port(pair["batch"]))["scores"].numpy()
    assert (got[..., UNK] == -1e10).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * ATOL
    tokens = got.argmax(-1)
    np.testing.assert_array_equal(tokens, want.argmax(-1))
    assert not (tokens == UNK).any()
    assert (tokens >= ANSWERS).any() and (tokens < ANSWERS).any()


def _jax_loss_and_grads(pair, batch):
    from mmf_tpu.modules.losses import MMFLoss

    rngs = {"dropout": jax.random.PRNGKey(0)}
    jb = dict(tree_map(jnp.asarray, batch), **META)

    def loss(params):
        out = pair["jm"].apply({"params": params}, jb, True, rngs=rngs)
        return list(MMFLoss("m4c_decoding_bce_with_mask")(jb, out)
                    .values())[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(
        pair["variables"]["params"])
    return float(value), {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(grads)).items()}


def _port_loss_and_grads(pair, batch):
    from mmf_tpu_torch.modules.losses import MMFLoss

    tm = pair["tm"].train()
    tm.zero_grad()
    pb = dict(_port(batch), **META)
    loss = list(MMFLoss("m4c_decoding_bce_with_mask")(pb, tm(pb))
                .values())[0]
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    tm.zero_grad()
    return float(loss.detach()), grads


@pytest.mark.parametrize("targets", ["no_unk", "unk"])
def test_loss_and_step0_gradients_match_jax(pair, targets):
    batch = _batches()[targets == "unk"]
    jloss, want = _jax_loss_and_grads(pair, batch)
    loss, got = _port_loss_and_grads(pair, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    if targets == "unk":
        assert loss > 1e9  # 1e10 a <unk> target, over the loss's count
    else:
        assert loss < 1e4
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        scale = max(float(np.abs(want[name]).max()), floor)
        err = float(np.abs(got[name] - want[name]).max()) / scale
        assert err < 5e-4, f"gradient mismatch at {name}: rel {err:.2e}"
    # the masked column passes no gradient to its bias (its row of
    # classifier_w is also the answer embedding the decode feeds back)
    assert not got["classifier_b"][UNK].any()


def test_unk_targets_change_the_loss_not_the_gradients(pair):
    clean, with_unk = _batches()
    _, g_clean = _port_loss_and_grads(pair, clean)
    _, g_unk = _port_loss_and_grads(pair, with_unk)
    for name in g_clean:
        np.testing.assert_array_equal(g_unk[name], g_clean[name],
                                      err_msg=name)


def test_adam_trajectory_with_lr_multipliers_matches_jax(pair):
    from mmf_tpu.config import omega as jomega
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu.modules.optimizers import build_optimizer_transform
    from mmf_tpu.modules.schedulers import build_scheduler as j_scheduler
    from mmf_tpu.trainers.core import train_state as jts
    from mmf_tpu_torch.config import omega as tomega
    from mmf_tpu_torch.models.m4c_captioner import M4CCaptioner
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
    tx = build_optimizer_transform(
        jcfg, schedule_fn=j_scheduler(jcfg), max_grad_norm=0.5,
        lr_multipliers=jm.get_lr_multipliers(jcfg))
    jstep = jax.jit(jts.make_train_step(jm.apply, JLosses(losses), tx,
                                        meta=META))
    jstate = jts.create_train_state({"params": variables["params"]}, tx,
                                    jax.random.PRNGKey(1))
    tm = M4CCaptioner(model_config())
    tm.load_state_dict(pair["tm"].state_dict())
    tcfg = tomega.create(TRAIN_CONFIG)
    multipliers = tm.get_lr_multipliers(tcfg)
    assert multipliers["text_bert"] == multipliers["obj_faster_rcnn_fc7"] \
        == 0.1
    opt = build_optimizer(tcfg, tm, lr_multipliers=multipliers)
    tstep = tts.make_train_step(
        Losses(losses), max_grad_norm=clip_gradients_config(tcfg),
        meta=META)
    tstate = tts.create_train_state(
        tm, opt, seed=1,
        lr_scheduler=build_lr_scheduler(opt, build_scheduler(tcfg)))
    batch = _batches()[0]
    jbatch = tree_map(jnp.asarray, batch)
    j_losses, t_losses = [], []
    for _ in range(4):
        jstate, jrep = jstep(jstate, jbatch)
        tstate, trep = tstep(tstate, batch)
        j_losses.append(float(jrep["total_loss"]))
        t_losses.append(float(trep["total_loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-4,
                               err_msg=f"jax {j_losses}\nport {t_losses}")
    assert t_losses[-1] < t_losses[0]
    want = params_from_jax(jax.device_get(jstate.variables["params"]))
    for name, p in tm.named_parameters():
        if name.endswith("key.bias"):
            # softmax is shift-invariant along keys: f32 noise on both
            # sides that Adam scales up (tests/test_torch_train_step.py)
            continue
        got, ref = p.detach().numpy(), want[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-8)
        err = float(np.abs(got - ref).max()) / scale
        assert err < 1e-3, f"post-training weight mismatch {name}: {err:.2e}"


@pytest.mark.parametrize("case", ["unk_idx", "registry", "other_dataset",
                                  "nothing", "off"])
def test_unk_index_resolves_as_in_jax(case):
    """Where ``<unk>``'s index comes from: the config's ``unk_idx``, the
    first dataset's answer processor (the model config's ``datasets``,
    else the registered config's), or nowhere (nothing masked);
    ``remove_unk_in_pred: false`` masks nothing."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.utils.env import setup_imports as jax_imports
    from mmf_tpu_torch.common.registry import registry as preg
    from mmf_tpu_torch.models.m4c_captioner import M4CCaptioner

    jax_imports()
    extra = {"unk_idx": {"unk_idx": 7}, "registry": {},
             "other_dataset": {"datasets": None}, "nothing": {},
             "off": {"remove_unk_in_pred": False}}[case]
    with registries_restored(empty=True):
        for reg in (jreg, preg):
            if case != "nothing":
                reg.register("textcaps_answer_processor", _AnswerProcessor())
            if case == "other_dataset":
                class Other:
                    UNK_IDX = 5
                reg.register("stvqa_answer_processor", Other())
                reg.register("config", {"datasets": "stvqa,textcaps"})
        jm = jreg.get_model_class("m4c_captioner")(config=model_config(
            **extra))
        tm = M4CCaptioner.__new__(M4CCaptioner)
        torch.nn.Module.__init__(tm)
        tm.config = model_config(**extra)
        want = jm._unk_idx() if case != "off" else None
        got = tm._unk_idx() if case != "off" else None
        assert got == want == {"unk_idx": 7, "registry": UNK,
                               "other_dataset": 5, "nothing": None,
                               "off": None}[case]
        scores = np.random.RandomState(0).randn(2, 3, 10).astype(np.float32)
        j_out = np.asarray(jm._finalize_scores(jnp.asarray(scores)))
        t_out = tm._finalize_scores(torch.from_numpy(scores.copy())).numpy()
        np.testing.assert_array_equal(t_out, j_out)
        assert (t_out != scores).any() == (case not in ("nothing", "off"))
