"""LXMERT in the port against the JAX package on the CPU: a small LXMERT
(2 language, 1 relational and 1 cross layer, 64 wide, 4 heads, 16-wide
region features) initialised in JAX, its params carried across by
``params_from_jax``, the same numpy inputs through both
(``tests/torch_vl3_models.py`` has the bars). The pretraining head (the
masked LM, the matched score with a -1 label among them, the feature
regression) and the classification heads (VQA2's and GQA's):
forwards, step-0 gradients, 4-step AdamW trajectories with the BERT
weight-decay mask, and the weights' round trip; the one cross-attention
module serves both directions."""

import numpy as np
import pytest
import torch

from tests.test_torch_vilt import jax_no_dropout  # noqa: F401 (a fixture)
from tests.torch_vl3_models import (
    assert_grads_match,
    assert_outputs_match,
    assert_round_trip,
    grads,
    jax_out,
    model,
    pair,
    port_out,
    trajectory,
)

torch.set_num_threads(2)  # several test workers share the host

H, V, DIM, LABELS = 64, 100, 16, 6
B, T, R = 4, 7, 5
SMALL = {"hidden_size": H, "num_attention_heads": 4,
         "intermediate_size": 2 * H, "vocab_size": V, "l_layers": 2,
         "r_layers": 1, "x_layers": 1, "visual_feat_dim": DIM,
         "num_labels": LABELS, "gqa_labels": 5, "hidden_dropout_prob": 0.0,
         "dtype": "float32"}
HEADS = {"pretraining": dict(SMALL, training_head_type="pretraining"),
         "classification": dict(SMALL, training_head_type="classification"),
         "gqa": dict(SMALL, training_head_type="gqa")}
META = {"dataset_name": "vqa2", "dataset_type": "train"}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, V, (B, T))
    mask = np.ones((B, T), np.int64)
    mask[1, T - 2:] = 0
    ids = ids * mask
    segments = np.zeros((B, T), np.int64)
    segments[:, T // 2:] = 1
    lm = np.where((rng.rand(B, T) < 0.3) & (mask > 0), ids, -1)
    lm[:, 2] = ids[:, 2]
    xy = 0.5 * rng.rand(B, R, 2)
    wh = 0.5 * rng.rand(B, R, 2)
    labels = np.where(rng.rand(B, R) < 0.4, 1, -1)
    labels[:, 0] = 1
    targets = np.zeros((B, LABELS), np.float32)
    targets[np.arange(B), rng.randint(0, LABELS, B)] = 1.0
    return {
        "input_ids": ids.astype(np.int64),
        "input_mask": mask,
        "segment_ids": segments * mask,
        "lm_label_ids": lm.astype(np.int64),
        "image_feature_0": rng.randn(B, R, DIM).astype(np.float32),
        "image_info_0": {"bbox": np.concatenate(
            [xy, xy + wh, wh.prod(-1, keepdims=True)], -1).astype(
                np.float32)},
        "image_mask": np.array([[1] * R, [1] * R, [1] * (R - 2) + [0] * 2,
                                [1] * R], np.int64),
        "image_labels": labels.astype(np.int64),
        # the masked datasets' -1: JAX's take_along_axis reads the last class
        "is_correct": np.array([1, 0, -1, 1], np.int64),
        "targets": targets,
    }


def _loss_names(head):
    return [] if head == "pretraining" else ["logit_bce"]


@pytest.fixture(scope="module")
def pairs():
    return {head: pair("lxmert", cfg, _batch(), META)
            for head, cfg in HEADS.items()}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_lxmert_forward_matches_jax(pairs, head):
    jm, variables, tm = pairs[head]
    batch = _batch(1)
    want = jax_out(jm, variables, batch, META)
    got = port_out(tm, batch, META)
    assert_outputs_match(want, got)
    if head == "pretraining":
        assert list(got["losses"]) == [
            "train/vqa2/masked_lm_loss", "train/vqa2/matched_loss",
            "train/vqa2/feat_loss"]
        assert got["scores"].shape == (B * T, V)
    else:
        assert got["scores"].shape == (B, 5 if head == "gqa" else LABELS)


def test_lxmert_matched_loss_reads_a_negative_label_as_jax(pairs):
    """Every label -1: JAX's ``take_along_axis`` counts it from the end,
    the port too."""
    jm, variables, tm = pairs["pretraining"]
    batch = _batch(2)
    batch["is_correct"][:] = -1
    assert_outputs_match(jax_out(jm, variables, batch, META),
                         port_out(tm, batch, META))


def test_lxmert_shares_one_cross_attention_module(pairs):
    """The cross layer's ``visual_attention`` serves both directions: one
    set of weights, called twice a forward, at Sq != Skv both ways."""
    _, _, tm = pairs["classification"]
    shapes = []
    tm.x_layer_0.visual_attention.register_forward_hook(
        lambda m, args, out: shapes.append((args[0].shape[1],
                                            args[1].shape[1])))
    port_out(tm, _batch(), META)
    assert shapes == [(T, R), (R, T)]
    assert sum("visual_attention" in k for k in tm.state_dict()) == 10


@pytest.mark.parametrize("head", ["pretraining", "classification"])
def test_lxmert_step0_gradients_match_jax(head, jax_no_dropout):
    want, got = grads("lxmert", HEADS[head], _batch(), META,
                      _loss_names(head))
    assert_grads_match(want, got)


@pytest.mark.parametrize("head", ["pretraining", "classification"])
def test_lxmert_adamw_trajectory_matches_jax(head, jax_no_dropout):
    trajectory("lxmert", HEADS[head], _batch(), META, _loss_names(head))


@pytest.mark.parametrize("head", sorted(HEADS))
def test_lxmert_params_round_trip_through_jax_converter(pairs, head):
    _, variables, tm = pairs[head]
    assert_round_trip(variables, tm)


def test_lxmert_weight_decay_mask_exempts_bias_and_layer_norm():
    tm = model("port", "lxmert", HEADS["classification"])
    mask = tm.get_weight_decay_mask()(tm)
    assert mask["l_layer_0.attention.query.weight"]
    assert not mask["l_layer_0.attention.query.bias"]
    assert not mask["x_layer_0.visual_attention.output_ln.weight"]
    assert not mask["visn_fc.box_ln.bias"]
