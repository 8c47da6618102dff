"""LoRRA against the JAX package on the CPU: ``lorra`` from
``configs/models/lorra/defaults.yaml`` at small widths (Pythia's text
LSTM 16, combine 20, classifier 24 / 12, 9 answers and 6 OCR copy
slots, 50 words, two feature sets of 7 regions x 16, 6 OCR tokens of 10
with their order vectors), f32, dropout 0, on the same weights (a JAX
init redrawn from a numpy seed and carried across by
``params_from_jax``) and seeded numpy inputs:

- the scores within atol 2e-5, and the context branch moving them (a
  changed OCR token, a shorter OCR length);
- the step-0 gradients of the configured ``logit_bce`` at cosine >=
  0.99999 for every parameter;
- 4 steps of Adamax (warmup ``multi_step``, global-norm clipping at
  0.25): the losses and every parameter within 1e-5 relative (but the
  biases under a softmax, whose gradient is 0 in exact arithmetic: the
  image attention's raw score and the text attention's maps; the OCR
  attention's sigmoid is held);
- the weights' round trip through JAX's ``convert_torch_state_dict``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_caption_models import (
    TRAJ_RTOL,
    assert_grads_match,
    assert_params_match,
    assert_round_trip,
    build,
    grads,
    init_shapes,
    load,
    randomize,
    trajectory,
)
from tests.torch_port_utils import registries_restored, tree_map

torch.set_num_threads(2)  # several test workers share the host

ATOL, GRAD_MIN_COSINE = 2e-5, 0.99999
V, T, K, D, ANSWERS, B = 50, 6, 7, 16, 9, 4
CD, L = 10, 6  # the OCR tokens' width and the copy slots
COMBINE = {"type": "non_linear_element_multiply",
           "params": {"dropout": 0, "hidden_dim": 20}}
OVERRIDES = {
    "text_vocab_size": V, "num_labels": ANSWERS + L, "image_feature_dim": D,
    "context_feature_dim": CD, "context_max_len": L,
    "classifier": {"type": "logit", "params": {"img_hidden_dim": 24,
                                               "text_hidden_dim": 12}},
    "image_feature_embeddings": [{
        "modal_combine": COMBINE, "normalization": "softmax",
        "transform": {"type": "linear", "params": {"out_dim": 1}}}],
    "context_feature_embeddings": [{
        "modal_combine": COMBINE, "normalization": "sigmoid",
        "transform": {"type": "linear", "params": {"out_dim": 1}}}],
    "image_text_modal_combine": {
        "type": "non_linear_element_multiply",
        "params": {"dropout": 0, "hidden_dim": 20, "context_dim": CD + L}},
    "text_embeddings": [{"type": "attention", "params": {
        "hidden_dim": 16, "num_layers": 1, "conv1_out": 8, "conv2_out": 2,
        "dropout": 0, "embedding_dim": 300, "kernel_size": 1,
        "padding": 0}}],
}
# the first dataset's features name two sets, as LoRRA's VQA2 config does
PORT_CONFIG = {"datasets": "vqa2", "dataset_config": {"vqa2": {
    "features": {"train": ["coco/defaults/a.lmdb,coco/resnet152/b.lmdb"]}}}}
# the biases under a softmax (the image attention's over the regions, the
# text attention's over time); the OCR attention's sigmoid is held
SKIP = tuple(f"image_feature_embeddings_{i}_0.image_attention_model.module."
             "transform.module.Dense_0.bias" for i in range(2)) + (
    "conv2.bias",)


def batch(seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, V, (B, T)).astype(np.int64)
    text[1, 4:] = 0
    lengths = np.array([6, 2, 0, 4])
    context = rng.randn(B, L, CD).astype(np.float32)
    context *= (np.arange(L)[None, :, None] < lengths[:, None, None])
    order = np.stack([np.eye(L, dtype=np.float32)] * B)
    order *= (np.arange(L)[None, :, None] < lengths[:, None, None])
    targets = np.zeros((B, ANSWERS + L), np.float32)
    targets[np.arange(B), rng.randint(ANSWERS, size=B)] = 1.0
    targets[0, ANSWERS + 2] = 0.6  # an OCR copy
    return {"text": text,
            "image_feature_0": rng.randn(B, K, D).astype(np.float32),
            "image_info_0": {"max_features": np.array([7, 4, 5, 6])},
            "image_feature_1": rng.randn(B, K, D).astype(np.float32),
            "context_feature_0": context,
            "context_info_0": {"max_features": lengths},
            "order_vectors": order, "targets": targets}


@contextlib.contextmanager
def port_config():
    from mmf_tpu_torch.common.registry import registry

    with registries_restored():
        registry.register("config", PORT_CONFIG)
        yield


def port_model(variables):
    with port_config():
        return load(build("port", "lorra", OVERRIDES), variables)


@pytest.fixture(scope="module")
def model():
    """(JAX model, redrawn variables, port model)."""
    jm = build("jax", "lorra", OVERRIDES)
    variables = randomize(init_shapes(jm, jax.random.PRNGKey(0), tree_map(
        jnp.asarray, batch()), False), seed=1)
    return jm, variables, port_model(variables)


def _scores(jm, variables, tm, b):
    want = np.asarray(jm.apply(variables, tree_map(jnp.asarray, b),
                               False)["scores"])
    with torch.no_grad():
        got = tm(tree_map(torch.from_numpy, b))["scores"].numpy()
    return want, got


def test_lorra_scores_match_jax(model):
    jm, variables, tm = model
    b = batch(5)
    want, got = _scores(jm, variables, tm, b)
    assert got.shape == (B, ANSWERS + L) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert_round_trip(variables, tm)
    assert {n.split(".")[0] for n, _ in tm.named_parameters()} >= {
        "context_feature_embeddings_0_0", "FinetuneFasterRcnnFpnFc7_0"}
    # the context branch moves the scores: another OCR token, a shorter
    # OCR length (the sigmoid attention masked past it)
    for change in ("token", "length"):
        c = batch(5)
        if change == "token":
            c["context_feature_0"][0, 1] += 1.0
        else:
            c["context_info_0"]["max_features"][0] = 3
        want_c, got_c = _scores(jm, variables, tm, c)
        np.testing.assert_allclose(got_c, want_c, atol=ATOL, rtol=0)
        assert np.abs(got_c[0] - got[0]).max() > 1e-4
        np.testing.assert_array_equal(got_c[1:], got[1:])


def test_lorra_gradients_and_trajectory_match_jax(model):
    jm, variables, _ = model
    tm = port_model(variables)
    b = batch(6)
    want, got = grads(jm, variables, tm, b, b, ["logit_bce"])
    assert_grads_match(want, got, GRAD_MIN_COSINE)
    b = batch(7)
    j_losses, t_losses, want = trajectory(jm, variables, tm, b, b,
                                          ["logit_bce"])
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    assert len(set(np.round(t_losses, 6))) > 1  # the weights moved
    assert_params_match(tm, want, skip=SKIP)
