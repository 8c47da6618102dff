"""UNITER in the port against the JAX package on the CPU: a small UNITER
(2 layers, 64 wide, 4 heads, 16-wide region features) initialised in
JAX, its params carried across by ``params_from_jax``, and the same numpy
inputs through both (``tests/torch_vl3_models.py`` has the bars). The
VQA2 head and every pretraining task (``mlm``, ``itm``, ``mrc``,
``mrfr``, ``wra``, and all of them at once, as evaluation runs them):
forwards, step-0 gradients, 4-step AdamW trajectories (the head's
``lr_multiplier`` set, and ignored on both sides), the weights' round
trip, and the task the trainer draws for an update."""

import random

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_vilt import jax_no_dropout  # noqa: F401 (a fixture)
from tests.torch_port_utils import tree_map
from tests.torch_vl3_models import (
    assert_grads_match,
    assert_outputs_match,
    assert_round_trip,
    grads,
    jax_out,
    pair,
    port_out,
    trajectory,
)

torch.set_num_threads(2)  # several test workers share the host

H, V, DIM, LABELS, CLS = 64, 100, 16, 6, 11
B, T, R = 4, 8, 5
TRUNK = {"hidden_size": H, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 2 * H, "vocab_size": V, "img_dim": DIM,
         "hidden_dropout_prob": 0.0, "dtype": "float32"}
VQA2 = dict(TRUNK, tasks="vqa2", heads={"vqa2": {
    "type": "mlp", "in_dim": H, "hidden_size": 2 * H, "num_labels": LABELS,
    "pooler_name": "bert_pooler", "lr_multiplier": 10,
    "hidden_dropout_prob": 0.0}})
TASKS = ["mlm", "itm", "mrc", "mrfr", "wra"]
PRETRAIN = dict(TRUNK, do_pretraining=True, tasks=",".join(TASKS), heads={
    "mlm": {"type": "mlm", "hidden_size": H, "vocab_size": V},
    "itm": {"type": "itm", "hidden_size": H},
    "mrc": {"type": "mrc", "hidden_size": H},
    "mrfr": {"type": "mrfr", "hidden_size": H},
    "wra": {"type": "wra"}})
VQA2_META = {"dataset_name": "vqa2", "dataset_type": "train"}
COCO_META = {"dataset_name": "masked_coco", "dataset_type": "train"}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, V, (B, T))
    mask = np.ones((B, T), np.int64)
    mask[0, T - 3:] = 0
    mask[2, T - 1:] = 0
    ids = ids * mask
    lm = np.where((rng.rand(B, T) < 0.3) & (mask > 0), ids, -1)
    lm[:, 1] = ids[:, 1]
    probs = rng.rand(B, R, CLS).astype(np.float32)
    probs[:, :, 0] = 0.0  # the KLD's zero-target branch
    probs /= probs.sum(-1, keepdims=True)
    xy = 0.5 * rng.rand(B, R, 2)
    wh = 0.5 * rng.rand(B, R, 2)
    labels = np.where(rng.rand(B, R) < 0.4, 1, -1)
    labels[:, 2] = 1
    targets = np.zeros((B, LABELS), np.float32)
    targets[np.arange(B), rng.randint(0, LABELS, B)] = 1.0
    return {
        "input_ids": ids.astype(np.int64),
        "input_ids_masked": np.where(lm >= 0, 3, ids).astype(np.int64),
        "input_mask": mask,
        "lm_label_ids": lm.astype(np.int64),
        "image_feature_0": rng.randn(B, R, DIM).astype(np.float32),
        "image_info_0": {
            "bbox": np.concatenate([xy, xy + wh, wh.prod(-1, keepdims=True)],
                                   -1).astype(np.float32),
            "cls_prob": probs},
        "image_labels": labels.astype(np.int64),
        "is_correct": np.array([1, 0, 1, 1], np.int64),
        "targets": targets,
    }


@pytest.fixture(scope="module")
def vqa2_pair():
    return pair("uniter", VQA2, _batch(), VQA2_META)


@pytest.fixture(scope="module")
def pretrain_pair():
    return pair("uniter", PRETRAIN, _batch(), COCO_META)


def test_uniter_vqa2_forward_matches_jax(vqa2_pair):
    jm, variables, tm = vqa2_pair
    batch = _batch(1)
    got = port_out(tm, batch, VQA2_META)
    assert_outputs_match(jax_out(jm, variables, batch, VQA2_META), got)
    assert got["scores"].shape == (B, LABELS)
    # the image stream reads the text stream's token-type table
    assert not any("img_embeddings.token_type" in k for k in tm.state_dict())


@pytest.mark.parametrize("task", TASKS + [None])
def test_uniter_pretraining_task_matches_jax(pretrain_pair, task):
    jm, variables, tm = pretrain_pair
    meta = dict(COCO_META, **({"task": task} if task else {}))
    batch = _batch(2)
    want = jax_out(jm, variables, batch, meta)
    got = port_out(tm, batch, meta)
    assert_outputs_match(want, got, keys=())
    assert len(got["losses"]) == (1 if task else len(TASKS))
    for value in got["losses"].values():
        assert np.isfinite(float(value))


def test_uniter_mrc_reads_zeros_without_class_probabilities():
    """With no ``cls_prob`` the ``mrc`` targets are 1601 zeros, as in JAX
    (the decoder is that wide; the KL divergence is 0)."""
    batch = _batch(3)
    del batch["image_info_0"]["cls_prob"]
    meta = dict(COCO_META, task="mrc")
    jm, variables, tm = pair("uniter", PRETRAIN, batch, COCO_META)
    assert tm.head_mrc.decoder.weight.shape == (1601, H)
    want = jax_out(jm, variables, batch, meta)
    got = port_out(tm, batch, meta)
    assert_outputs_match(want, got, keys=())
    assert float(got["losses"]["train/masked_coco/mrc_loss"]) == 0.0


@pytest.mark.parametrize("task", ["vqa2"] + TASKS)
def test_uniter_step0_gradients_match_jax(task, jax_no_dropout):
    if task == "vqa2":
        want, got = grads("uniter", VQA2, _batch(), VQA2_META,
                          ["logit_bce"])
    else:
        want, got = grads("uniter", PRETRAIN, _batch(),
                          dict(COCO_META, task=task))
    assert_grads_match(want, got)
    if task in ("mrc", "mrfr"):
        # the masked regions take the learned mask row
        assert np.any(got["uniter.img_embeddings.mask_embedding.weight"])


@pytest.mark.parametrize("task", ["vqa2", "mlm", "mrfr"])
def test_uniter_adamw_trajectory_matches_jax(task, jax_no_dropout):
    if task == "vqa2":
        trajectory("uniter", VQA2, _batch(), VQA2_META, ["logit_bce"])
    else:
        trajectory("uniter", PRETRAIN, _batch(), dict(COCO_META, task=task))


@pytest.mark.parametrize("which", ["vqa2", "pretraining"])
def test_uniter_params_round_trip_through_jax_converter(
        which, vqa2_pair, pretrain_pair):
    _, variables, tm = vqa2_pair if which == "vqa2" else pretrain_pair
    assert_round_trip(variables, tm)


def test_uniter_step_meta_draws_as_jax():
    """The per-update task comes from Python's ``random``, one draw an
    update, as JAX's ``get_step_meta``: the same seed gives the same
    sequence; classification draws nothing."""
    from mmf_tpu.common.registry import registry as jax_registry
    from tests.torch_vl3_models import model

    jm = jax_registry.get_model_class("uniter")(config=dict(PRETRAIN))
    tm = model("port", "uniter", PRETRAIN)
    random.seed(7)
    want = [jm.get_step_meta()["task"] for _ in range(20)]
    random.seed(7)
    got = [tm.get_step_meta()["task"] for _ in range(20)]
    assert got == want and set(got) == set(TASKS)
    state = random.getstate()
    assert model("port", "uniter", VQA2).get_step_meta() == {}
    assert random.getstate() == state


def test_uniter_runs_the_trunk_once_a_task():
    """A pretraining forward runs the trunk once for its task, and once
    a task when evaluation gives none."""
    tm = model_with_counter()
    batch = tree_map(torch.from_numpy, _batch())
    with torch.no_grad():
        tm(dict(batch, **COCO_META, task="itm"))
        assert tm.calls == 1
        tm(dict(batch, **COCO_META))
        assert tm.calls == 1 + len(TASKS)


def model_with_counter():
    from tests.torch_vl3_models import model

    tm = model("port", "uniter", PRETRAIN)
    tm.materialize(tree_map(torch.from_numpy, _batch()))
    tm.init_weights(torch.Generator().manual_seed(0)).eval()
    tm.calls = 0

    def count(*args):
        tm.calls += 1

    tm.uniter.register_forward_hook(lambda *a: count())
    return tm


def test_jax_init_has_every_head():
    """flax builds the heads of the tasks an init calls: with no task
    given every task runs, so every head has weights to carry across
    (``wra`` has none)."""
    _, variables, tm = pair("uniter", PRETRAIN, _batch(), COCO_META)
    names = set(jax.device_get(variables["params"]))
    assert names == {"uniter"} | {f"head_{t}" for t in TASKS if t != "wra"}
    assert {n.split(".")[0] for n in tm.state_dict()} == names
