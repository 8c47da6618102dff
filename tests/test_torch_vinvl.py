"""VinVL in the port against the JAX package on the CPU: a small VinVL
(2 layers, 64 wide, 4 heads, 16-wide region features) initialised in
JAX, its params carried across by ``params_from_jax``, the same numpy
inputs through both (``tests/torch_vl3_models.py`` has the bars). The
classification head (with 0 and 2 transform layers, and its in-model
``ce`` loss) and the pretraining head (the masked LM and the three-way
contrastive loss over a second pass of the trunk on the corrupted pair,
or over the first pass's pooled output without one): forwards, step-0
gradients, 4-step AdamW trajectories, and the weights' round trip."""

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
    model,
    pair,
    port_out,
    trajectory,
)

torch.set_num_threads(2)  # several test workers share the host

H, V, DIM, LABELS = 64, 100, 16, 6
B, T, R = 4, 9, 5
SMALL = {"hidden_size": H, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 2 * H, "vocab_size": V, "num_labels": LABELS,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
         "dtype": "float32"}
CASES = {
    "classification": dict(SMALL),
    "classification_mlp2": dict(SMALL, mlp_num_layers=2),
    "pretraining": dict(SMALL, training_head_type="pretraining"),
}
META = {"dataset_name": "vinvl", "dataset_type": "train"}


def _pair_ids(rng, mask_rate=0.0):
    """A caption and a tag string as one BERT pair: ids, mask, segments."""
    ids = rng.randint(5, V, (B, T))
    mask = np.ones((B, T), np.int64)
    mask[0, T - 3:] = 0
    segments = np.zeros((B, T), np.int64)
    segments[:, 4:] = 1
    return ids * mask, mask, segments * mask


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids, mask, segments = _pair_ids(rng)
    lm = np.where((rng.rand(B, T) < 0.3) & (mask > 0), ids, -1)
    lm[:, 1] = ids[:, 1]
    corrupt_ids, corrupt_mask, corrupt_segments = _pair_ids(rng)
    targets = np.zeros((B, LABELS), np.float32)
    targets[np.arange(B), rng.randint(0, LABELS, B)] = 1.0
    return {
        "input_ids": ids.astype(np.int64),
        "input_ids_masked": np.where(lm >= 0, 3, ids).astype(np.int64),
        "input_mask": mask,
        "segment_ids": segments,
        "lm_label_ids": lm.astype(np.int64),
        "input_ids_corrupt": corrupt_ids.astype(np.int64),
        "input_mask_corrupt": corrupt_mask,
        "segment_ids_corrupt": corrupt_segments,
        "contrastive_labels": np.array([0, 1, 2, 1], np.int64),
        "image_feature_0": rng.randn(B, R, DIM).astype(np.float32),
        "image_mask": np.array([[1] * R, [1] * (R - 1) + [0], [1] * R,
                                [1] * R], np.int64),
        "targets": targets,
    }


def _loss_names(case):
    return [] if case == "pretraining" else ["logit_bce"]


@pytest.fixture(scope="module")
def pairs():
    return {case: pair("vinvl", cfg, _batch(), META)
            for case, cfg in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vinvl_forward_matches_jax(pairs, case):
    jm, variables, tm = pairs[case]
    batch = _batch(1)
    want = jax_out(jm, variables, batch, META)
    got = port_out(tm, batch, META)
    assert_outputs_match(want, got)
    if case == "pretraining":
        assert list(got["losses"]) == [
            "train/vinvl/masked_lm_loss",
            "train/vinvl/three_way_contrastive_loss"]


def test_vinvl_contrastive_loss_without_a_corrupted_pair(pairs):
    """Without ``input_ids_corrupt`` the three-way classifier reads the
    first pass's pooled output, as in JAX."""
    jm, variables, tm = pairs["pretraining"]
    batch = _batch(2)
    for key in ("input_ids_corrupt", "input_mask_corrupt",
                "segment_ids_corrupt"):
        del batch[key]
    assert_outputs_match(jax_out(jm, variables, batch, META),
                         port_out(tm, batch, META))


def test_vinvl_in_model_cross_entropy(pairs):
    """With ``labels`` in the batch the classifier adds its ``ce``."""
    jm, variables, tm = pairs["classification"]
    batch = dict(_batch(3), labels=np.array([0, 5, 2, 1], np.int64))
    got = port_out(tm, batch, META)
    assert list(got["losses"]) == ["train/vinvl/ce"]
    assert_outputs_match(jax_out(jm, variables, batch, META), got)


def test_vinvl_runs_the_trunk_twice_for_the_corrupted_pair(pairs):
    _, _, tm = pairs["pretraining"]
    calls = []
    handle = tm.encoder.register_forward_hook(lambda *a: calls.append(1))
    port_out(tm, _batch(), META)
    handle.remove()
    assert len(calls) == 2


@pytest.mark.parametrize("case", ["classification_mlp2", "pretraining"])
def test_vinvl_step0_gradients_match_jax(case, jax_no_dropout):
    want, got = grads("vinvl", CASES[case], _batch(), META, _loss_names(case))
    assert_grads_match(want, got)


@pytest.mark.parametrize("case", ["classification", "pretraining"])
def test_vinvl_adamw_trajectory_matches_jax(case, jax_no_dropout):
    trajectory("vinvl", CASES[case], _batch(), META, _loss_names(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vinvl_params_round_trip_through_jax_converter(pairs, case):
    _, variables, tm = pairs[case]
    assert_round_trip(variables, tm)


def test_vinvl_region_projection_is_sized_by_the_data():
    """flax takes the projection's input width from the features:
    ``materialize`` sizes it from a batch; a state dict sizes it when it
    loads."""
    tm = model("port", "vinvl", SMALL)
    assert tm.has_uninitialized_params()
    tm.materialize(tree_map(torch.from_numpy, _batch()))
    assert tuple(tm.img_projection.weight.shape) == (H, DIM)
    tm.init_weights(torch.Generator().manual_seed(0))
    fresh = model("port", "vinvl", SMALL)
    fresh.load_state_dict(tm.state_dict(), strict=True)
    assert tuple(fresh.img_projection.weight.shape) == (H, DIM)
