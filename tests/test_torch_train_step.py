"""The slice as a whole: the port's train step against the JAX package's
``make_train_step`` with ``build_optimizer_transform``, on a tiny
VisualBERT in f32 with dropout 0. AdamW with the BERT no-decay mask,
``warmup_cosine``, global-norm clipping, logit_bce; 4 updates at
``update_frequency`` 1 and 2. The bars are the repo's own
(``tests/reference_parity/test_training_dynamics_parity.py``): per-step
loss within rtol 2e-4, step-0 gradients within relative 5e-4 (over a
floor of 1e-3 of the global gradient scale), parameters after 4 steps
within relative 1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmf_tpu.config import omega as jomega
from mmf_tpu.modules.losses import Losses as JLosses
from mmf_tpu.modules.optimizers import build_optimizer_transform
from mmf_tpu.modules.schedulers import build_scheduler as j_build_scheduler
from mmf_tpu.trainers.core import train_state as jts
from mmf_tpu_torch.config import omega as tomega
from mmf_tpu_torch.modules.losses import Losses as TLosses
from mmf_tpu_torch.modules.optimizers import build_optimizer
from mmf_tpu_torch.modules.schedulers import (
    build_lr_scheduler,
    build_scheduler,
)
from mmf_tpu_torch.modules.transformer import dropout_generator
from mmf_tpu_torch.trainers.core import train_state as tts
from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from mmf_tpu_torch.utils.flagship import vqa2_train_batch
from mmf_tpu_torch.utils.general import clip_gradients_config
from tests.torch_port_utils import TINY, init_pair, tree_map

torch.set_num_threads(2)  # several test workers share the host

STEPS = 4
META = {"dataset_name": "vqa2", "dataset_type": "train"}
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
CONFIG = {
    "training": {"lr_scheduler": True, "max_updates": 10,
                 "clip_gradients": True, "max_grad_l2_norm": 0.5},
    "optimizer": {"type": "adam_w", "params": {"lr": 1e-3, "eps": 1e-8}},
    "scheduler": {"type": "warmup_cosine",
                  "params": {"num_warmup_steps": 2,
                             "num_training_steps": 10}},
}


def _batch(n=4):
    b = vqa2_train_batch(n, 8, 5, TINY["visual_embedding_dim"],
                         TINY["vocab_size"], TINY["num_labels"], seed=5)
    b["input_mask"][0, 6:] = 0
    b["image_info_0"]["max_features"][-1] = 3
    return b


def _rel_err(a, b, floor=1e-8):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              floor)


def _pair():
    batch = _batch()
    overrides = dict(TINY, **NO_DROPOUT, pooler_strategy="vqa")
    jm, variables, tm = init_pair(overrides, batch)
    return batch, jm, variables, tm


def _jax_loss_fn(jm, losses, batch):
    jb = dict(tree_map(jnp.asarray, batch), **META)

    def loss(params):
        out = jm.apply({"params": params}, jb, True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.mean(v) for v in losses(jb, out).values())

    return loss


def test_step0_gradients_match_jax():
    batch, jm, variables, tm = _pair()
    want = jax.grad(_jax_loss_fn(jm, JLosses(["logit_bce"]), batch))(
        variables["params"])
    want = {k: v.numpy() for k, v in
            params_from_jax(jax.device_get(want)).items()}

    tm.train()
    tb = dict(tree_map(torch.from_numpy, batch), **META)
    with dropout_generator(None):
        out = tm(tb)
    sum(v.mean() for v in TLosses(["logit_bce"])(tb, out).values()).backward()
    # a parameter the loss does not reach (the pooler, under the vqa
    # pooler strategy) has no torch gradient and a zero JAX one
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        err = _rel_err(got[name], want[name], floor)
        assert err < 5e-4, f"gradient mismatch at {name}: rel {err:.2e}"


@pytest.mark.parametrize("update_frequency", [1, 2])
def test_train_steps_match_jax(update_frequency):
    batch, jm, variables, tm = _pair()
    jcfg = jomega.create(CONFIG)
    tx = build_optimizer_transform(
        jcfg, schedule_fn=j_build_scheduler(jcfg), max_grad_norm=0.5,
        weight_decay_mask=jm.get_weight_decay_mask(jcfg))
    jstep = jax.jit(jts.make_train_step(
        jm.apply, JLosses(["logit_bce"]), tx,
        update_frequency=update_frequency, meta=META))
    jstate = jts.create_train_state(
        {"params": variables["params"]}, tx, jax.random.PRNGKey(1))

    tcfg = tomega.create(CONFIG)
    opt = build_optimizer(tcfg, tm,
                          weight_decay_mask=tm.get_weight_decay_mask(tcfg))
    tstep = tts.make_train_step(
        TLosses(["logit_bce"]), update_frequency=update_frequency,
        max_grad_norm=clip_gradients_config(tcfg), meta=META)
    tstate = tts.create_train_state(
        tm, opt, seed=1,
        lr_scheduler=build_lr_scheduler(opt, build_scheduler(tcfg)))

    jbatch = tree_map(jnp.asarray, batch)
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        jstate, jrep = jstep(jstate, jbatch)
        tstate, trep = tstep(tstate, batch)
        j_losses.append(float(jrep["total_loss"]))
        t_losses.append(float(trep["total_loss"]))
        assert list(trep["losses"]) == list(jrep["losses"]) == [
            "train/vqa2/logit_bce"]
        assert not bool(trep["nan_flag"])
        assert trep["num_updates"] == int(jrep["num_updates"])
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-4,
                               err_msg=f"jax {j_losses}\nport {t_losses}")
    # warmup_cosine runs update 0 at lr 0; every later update moves
    assert t_losses[1] == t_losses[0] and len(set(t_losses)) == STEPS - 1

    want = params_from_jax(jax.device_get(jstate.variables["params"]))
    for name, p in tm.named_parameters():
        if name.endswith("key.bias"):
            # softmax is shift-invariant along keys: the key bias gets a
            # gradient of pure f32 cancellation noise on both sides, which
            # Adam scales up to lr-sized steps (the reference test skips
            # it for the same reason); the losses above pin the function
            continue
        err = _rel_err(p.detach().numpy(), want[name].numpy())
        assert err < 1e-3, f"post-training weight mismatch {name}: {err:.2e}"


def test_update_frequency_splits_match_the_unsplit_step():
    """Accumulating 2 microbatches gives the update of the whole batch."""
    batch, _, _, tm = _pair()
    tm2 = type(tm)(tm.config)
    tm2.load_state_dict(tm.state_dict())
    cfg = tomega.create(CONFIG)
    states = []
    for model, uf in ((tm, 1), (tm2, 2)):
        opt = build_optimizer(cfg, model,
                              weight_decay_mask=model.get_weight_decay_mask())
        step = tts.make_train_step(TLosses(["logit_bce"]), uf, 0.5,
                                   meta=META, report_fields=("scores",))
        state = tts.create_train_state(
            model, opt, 0, build_lr_scheduler(opt, build_scheduler(cfg)))
        reps = []
        for _ in range(3):
            state, rep = step(state, batch)
            reps.append(rep)
        states.append((state, reps))
    (s1, r1), (s2, r2) = states
    for a, b in zip(r1, r2):
        np.testing.assert_allclose(float(a["total_loss"]),
                                   float(b["total_loss"]), rtol=1e-5)
        assert a["scores"].shape == b["scores"].shape == (4, TINY[
            "num_labels"])
    for (n, p), (_, q) in zip(s1.model.named_parameters(),
                              s2.model.named_parameters()):
        if not n.endswith("key.bias"):
            assert _rel_err(q.detach().numpy(), p.detach().numpy()) < 1e-4, n


def test_vqa2_trainer_trains_on_the_card_by_default():
    """``vqa2_trainer(model, cfg)`` means the card: without one it raises
    instead of training on the CPU; ``device="cpu"`` must be asked for,
    and then the VQA2 config's step trains there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would work")
    from mmf_tpu_torch.utils import flagship

    cfg = flagship.vqa2_config(["scheduler.params.num_warmup_steps=2"])
    model = flagship.vqa2_visual_bert(cfg, dict(TINY, **NO_DROPOUT))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship.vqa2_trainer(model, cfg)
    state, step = flagship.vqa2_trainer(model, cfg, seed=0, device="cpu")
    assert all(g["initial_lr"] == pytest.approx(5e-5)
               for g in state.optimizer.param_groups)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = []
    for _ in range(3):  # warmup_cosine runs update 0 at lr 0
        state, rep = step(state, _batch())
        losses.append(float(rep["total_loss"]))
        assert list(rep["losses"]) == ["train/vqa2/logit_bce"]
    assert state.step == 3 and np.isfinite(losses).all()
    assert losses[1] == losses[0] and losses[2] != losses[1]
    assert any(not torch.equal(p, start[n])
               for n, p in model.named_parameters())


def test_dropout_draws_from_the_step_generator():
    """Hidden dropout is active in training and reproducible from the
    state's seed; without a generator, training-mode dropout raises."""
    batch = _batch()
    overrides = dict(TINY, hidden_dropout_prob=0.3,
                     attention_probs_dropout_prob=0.2)
    _, _, tm = init_pair(overrides, batch)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    cfg = tomega.create(CONFIG)

    def run(seed):
        tm.load_state_dict(start)
        opt = build_optimizer(cfg, tm)
        step = tts.make_train_step(TLosses(["logit_bce"]), meta=META)
        state = tts.create_train_state(tm, opt, seed)
        return [float(step(state, batch)[1]["total_loss"])
                for state in [state]][0]

    assert run(3) == run(3)
    assert run(3) != run(4)
    tm.train()
    with pytest.raises(RuntimeError, match="generator"):
        tm(dict(tree_map(torch.from_numpy, batch), **META))
    eval_out = tts.make_eval_step(TLosses(["logit_bce"]), META)(tm, batch)
    assert not tm.training and "train/vqa2/logit_bce" in eval_out["losses"]
