"""The pretraining heads of the port against the JAX package on the CPU:
``TextEmbeddings``, ``TransformerModel`` and ``MLMHead`` (tied and
untied), VisualBERT's ``pretraining`` output, its masked-LM loss (0 at
zero labelled positions, not NaN), step-0 gradients and a 4-step AdamW +
``warmup_linear`` trajectory, and MMBT's pretraining head on direct
features. Small size: 2 layers, hidden 64, 4 heads, vocab 101, f32,
dropout 0; weights carried by ``params_from_jax``. The bars are those of
``tests/test_torch_train_step.py``: logits atol 2e-5, loss rtol 1e-5,
gradients relative 5e-4 over a floor of 1e-3 of the global scale,
trajectory losses rtol 2e-4 and parameters relative 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import init_pair, tree_map

torch.set_num_threads(2)  # several test workers share the host

SMALL = {
    "vocab_size": 101,
    "hidden_size": 64,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 128,
    "visual_embedding_dim": 16,
    "max_position_embeddings": 32,
    "dtype": "float32",
    "hidden_dropout_prob": 0.0,
    "attention_probs_dropout_prob": 0.0,
    "training_head_type": "pretraining",
}
META = {"dataset_name": "masked_coco", "dataset_type": "train"}
LOSS_KEY = "train/masked_coco/masked_lm_loss"
LOGITS_ATOL = 2e-5
STEPS = 4
CONFIG = {
    "training": {"lr_scheduler": True, "max_updates": 10},
    "optimizer": {"type": "adam_w", "params": {"lr": 1e-3, "eps": 1e-8}},
    "scheduler": {"type": "warmup_linear",
                  "params": {"num_warmup_steps": 2,
                             "num_training_steps": 10}},
}


def _configs():
    from mmf_tpu.modules.transformer import TransformerConfig as JConfig
    from mmf_tpu_torch.modules.transformer import TransformerConfig

    keys = ("vocab_size", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size",
            "max_position_embeddings", "dtype", "hidden_dropout_prob",
            "attention_probs_dropout_prob")
    d = {k: SMALL[k] for k in keys}
    return JConfig.from_dict(d), TransformerConfig.from_dict(d)


def _text_inputs(b=3, t=9, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, SMALL["vocab_size"], (b, t)).astype(np.int32)
    ids[0, -2:] = 0  # padding ids
    mask = (ids != 0).astype(np.int32)
    types = np.zeros((b, t), np.int32)
    types[1, t // 2:] = 1
    return ids, mask, types


def _port(module, variables):
    module.load_state_dict(params_from_jax(jax.device_get(
        variables["params"])), strict=True)
    return module.eval()


def test_text_embeddings_and_transformer_model_match_jax():
    from mmf_tpu.modules.transformer import TextEmbeddings as JEmb
    from mmf_tpu.modules.transformer import TransformerModel as JModel
    from mmf_tpu_torch.modules.transformer import (
        TextEmbeddings,
        TransformerModel,
    )

    jcfg, tcfg = _configs()
    ids, mask, types = _text_inputs()
    jemb = JEmb(jcfg)
    variables = jemb.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                          jnp.asarray(types))
    want = np.asarray(jemb.apply(variables, jnp.asarray(ids),
                                 jnp.asarray(types)))
    temb = _port(TextEmbeddings(tcfg), variables)
    with torch.no_grad():
        got = temb(torch.from_numpy(ids), torch.from_numpy(types)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)

    jm = JModel(jcfg)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                        jnp.asarray(mask), jnp.asarray(types))
    want_seq, want_pooled = jm.apply(variables, jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(types))
    tm = _port(TransformerModel(tcfg), variables)
    with torch.no_grad():
        seq, pooled = tm(torch.from_numpy(ids), torch.from_numpy(mask),
                         torch.from_numpy(types))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("tied", [False, True])
def test_mlm_head_matches_jax(tied):
    from mmf_tpu.modules.transformer import MLMHead as JHead
    from mmf_tpu_torch.modules.transformer import MLMHead

    jcfg, tcfg = _configs()
    rng = np.random.RandomState(3)
    hidden = rng.randn(2, 7, SMALL["hidden_size"]).astype(np.float32)
    table = (0.05 * rng.randn(SMALL["vocab_size"], SMALL["hidden_size"])
             ).astype(np.float32)
    args = (jnp.asarray(hidden),) + ((jnp.asarray(table),) if tied else ())
    jh = JHead(jcfg)
    variables = jh.init(jax.random.PRNGKey(2), *args)
    if tied:  # a non-zero bias, so that its mapping shows
        variables = {"params": dict(variables["params"], bias=jnp.asarray(
            rng.randn(SMALL["vocab_size"]).astype(np.float32)))}
    want = np.asarray(jh.apply(variables, *args))
    th = _port(MLMHead(tcfg, tied=tied), variables)
    with torch.no_grad():
        got = th(torch.from_numpy(hidden),
                 torch.from_numpy(table) if tied else None).numpy()
    assert got.shape == want.shape == (2, 7, SMALL["vocab_size"])
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    with pytest.raises(ValueError, match="shared_embedding"):
        th(torch.from_numpy(hidden),
           None if tied else torch.from_numpy(table))


def _batch(n=4, seed=0):
    from mmf_tpu_torch.utils.flagship import masked_coco_train_batch

    b = masked_coco_train_batch(n, 8, 5, SMALL["visual_embedding_dim"],
                                SMALL["vocab_size"], mask_probability=0.4,
                                seed=seed)
    b["input_mask"][0, 6:] = 0
    b["lm_label_ids"][0, 6:] = -1
    b["image_info_0"]["max_features"][-1] = 3
    assert (b["lm_label_ids"] != -1).sum() >= 3
    return b


def _pair(batch, overrides=None):
    return init_pair(dict(SMALL, **(overrides or {})), batch)


def _jax_out(jm, variables, batch, train=False):
    jb = dict(tree_map(jnp.asarray, batch), **META)
    return jm.apply(variables, jb, train,
                    rngs={"dropout": jax.random.PRNGKey(0)})


def _port_out(tm, batch):
    with torch.no_grad():
        return tm.eval()(dict(tree_map(torch.from_numpy, batch), **META))


def test_visual_bert_pretraining_output_matches_jax():
    batch = _batch()
    jm, variables, tm = _pair(batch)
    assert "cls" in variables["params"] and "seq_relationship" in \
        variables["params"]
    want = _jax_out(jm, variables, batch)
    got = _port_out(tm, batch)
    assert set(got) == set(want) == {"scores", "seq_relationship_score",
                                     "losses"}
    assert got["scores"].shape == want["scores"].shape == (
        4 * (8 + 5), SMALL["vocab_size"])
    for key in ("scores", "seq_relationship_score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=LOGITS_ATOL, rtol=0)
    assert list(got["losses"]) == list(want["losses"]) == [LOSS_KEY]
    np.testing.assert_allclose(float(got["losses"][LOSS_KEY]),
                               float(want["losses"][LOSS_KEY]), rtol=1e-5)


def test_masked_lm_loss_is_zero_without_labelled_positions():
    batch = _batch()
    batch["lm_label_ids"][...] = -1
    jm, variables, tm = _pair(batch)
    want = float(_jax_out(jm, variables, batch)["losses"][LOSS_KEY])
    got = float(_port_out(tm, batch)["losses"][LOSS_KEY])
    assert want == 0.0 and got == 0.0
    # and the gradient through it is finite (zero)
    tm.train()
    out = tm(dict(tree_map(torch.from_numpy, batch), **META))
    out["losses"][LOSS_KEY].backward()
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters()
               if p.grad is not None)


def _rel_err(a, b, floor=1e-8):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              floor)


def test_visual_bert_pretraining_step0_gradients_match_jax():
    batch = _batch()
    jm, variables, tm = _pair(batch)
    jb = dict(tree_map(jnp.asarray, batch), **META)

    def loss(params):
        return jm.apply({"params": params}, jb, True,
                        rngs={"dropout": jax.random.PRNGKey(0)}
                        )["losses"][LOSS_KEY]

    want = {k: v.numpy() for k, v in params_from_jax(jax.device_get(
        jax.grad(loss)(variables["params"]))).items()}
    tm.train()
    from mmf_tpu_torch.modules.transformer import dropout_generator

    with dropout_generator(None):
        out = tm(dict(tree_map(torch.from_numpy, batch), **META))
    out["losses"][LOSS_KEY].backward()
    # the pooler and the NSP head take no part in the loss: no torch
    # gradient, a zero JAX one
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        err = _rel_err(got[name], want[name], floor)
        assert err < 5e-4, f"gradient mismatch at {name}: rel {err:.2e}"


def test_visual_bert_pretraining_trajectory_matches_jax():
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

    batch = _batch()
    jm, variables, tm = _pair(batch)
    jcfg = jomega.create(CONFIG)
    tx = build_optimizer_transform(
        jcfg, schedule_fn=j_scheduler(jcfg),
        weight_decay_mask=jm.get_weight_decay_mask(jcfg))
    jstep = jax.jit(jts.make_train_step(jm.apply, JLosses([]), tx,
                                        meta=META))
    jstate = jts.create_train_state({"params": variables["params"]}, tx,
                                    jax.random.PRNGKey(1))
    tcfg = tomega.create(CONFIG)
    opt = build_optimizer(tcfg, tm,
                          weight_decay_mask=tm.get_weight_decay_mask(tcfg))
    tstep = tts.make_train_step(Losses([]), meta=META)
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
        assert list(trep["losses"]) == list(jrep["losses"]) == [LOSS_KEY]
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-4,
                               err_msg=f"jax {j_losses}\nport {t_losses}")
    # warmup_linear runs update 0 at lr 0; every later update moves
    assert t_losses[1] == t_losses[0] and len(set(t_losses)) == STEPS - 1
    want = params_from_jax(jax.device_get(jstate.variables["params"]))
    for name, p in tm.named_parameters():
        if name.endswith("key.bias"):
            # the key bias's true gradient is 0 (softmax is shift-invariant
            # along keys): f32 noise on both sides that Adam scales up
            continue
        err = _rel_err(p.detach().numpy(), want[name].numpy())
        assert err < 1e-3, f"post-training weight mismatch {name}: {err:.2e}"


def _small_mmbt(load_yaml):
    mc = load_yaml("configs/models/mmbt/defaults.yaml")["model_config"][
        "mmbt"]
    mc["training_head_type"] = "pretraining"
    mc["direct_features_input"] = True
    mc["modal_hidden_size"] = 16
    mc["dtype"] = "float32"
    mc["text_encoder"]["params"].update(
        {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 128, "vocab_size": SMALL["vocab_size"]})
    return mc


def test_mmbt_pretraining_matches_jax():
    from mmf_tpu.common.registry import registry as jax_registry
    from mmf_tpu.config.configuration import load_yaml as jax_load_yaml
    from mmf_tpu.utils.env import setup_imports as jax_setup_imports
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    jax_setup_imports()
    setup_imports()
    rng = np.random.RandomState(7)
    b, t = 3, 10
    batch = {
        "input_ids": rng.randint(5, SMALL["vocab_size"], (b, t)).astype(
            np.int32),
        "input_mask": np.ones((b, t), np.int32),
        "segment_ids": np.zeros((b, t), np.int32),
        "image_feature_0": rng.randn(b, 4, 16).astype(np.float32),
    }
    batch["input_mask"][0, t - 3:] = 0
    batch["lm_label_ids"] = np.where(
        (rng.rand(b, t) < 0.4) & (batch["input_mask"] > 0),
        batch["input_ids"], -1).astype(np.int32)
    jm = jax_registry.get_model_class("mmbt")(
        config=_small_mmbt(jax_load_yaml))
    jb = dict(tree_map(jnp.asarray, batch), **META)
    variables = jm.init(jax.random.PRNGKey(0), jb, False)
    want = jm.apply(variables, jb, False)
    tm = registry.get_model_class("mmbt")(config=_small_mmbt(load_yaml))
    _port(tm, variables)
    got = _port_out(tm, batch)
    assert got["scores"].shape == want["scores"].shape == (
        b * t, SMALL["vocab_size"])
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(got["losses"][LOSS_KEY]),
                               float(want["losses"][LOSS_KEY]), rtol=1e-5)
