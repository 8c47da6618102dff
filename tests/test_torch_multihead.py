"""Pythia's ``multihead`` and ``MultiHeadImageFeatureEmbedding`` against
the JAX package on the CPU.

- ``MultiHeadImageFeatureEmbedding``: one query row (the question) over
  the regions, at head dims 16 and 160 (the card runs 256 through the
  wide kernels; here the plain version), within atol 2e-5;
- ``multihead`` from Pythia's defaults at the small widths of
  ``tests/test_torch_pythia.py`` (its 32-wide text embedding attending
  over 7 regions x 16 in 2 heads of 16), f32, dropout 0, on the same
  weights (a JAX init redrawn from a numpy seed, carried across by
  ``params_from_jax``) and seeded numpy inputs: the scores within atol
  2e-5, the step-0 gradients of ``logit_bce`` at cosine >= 0.99999 for
  every parameter, 4 steps of the configs' Adamax with the warmup
  ``multi_step`` schedule and clipping, in float64 on both sides (as
  BUTD's: Adamax's normalised step turns f32 rounding in a small
  gradient into moves of the order of the learning rate; flax's LSTM
  carry started in float64 for it): the losses and
  every parameter within 1e-5 relative, but the key projection's bias,
  whose gradient is 0 in exact arithmetic (``SHIFT_INVARIANT``); the
  weights' round trip through JAX's ``convert_torch_state_dict``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pythia import ANSWERS, B, COMBINE, D, OVERRIDES, batch
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
from tests.torch_port_utils import tree_map

torch.set_num_threads(2)  # several test workers share the host

ATOL, GRAD_MIN_COSINE = 2e-5, 0.99999
MULTIHEAD = dict(OVERRIDES, image_feature_embeddings=[{
    "num_heads": 2, "modal_combine": COMBINE, "normalization": "softmax",
    "transform": {"type": "linear", "params": {"out_dim": 1}}}])


@pytest.fixture(scope="module")
def model():
    jm = build("jax", "multihead", MULTIHEAD)
    variables = randomize(init_shapes(jm, jax.random.PRNGKey(0), tree_map(
        jnp.asarray, batch()), False), seed=1)
    return jm, variables


@pytest.mark.parametrize("question_dim,heads", [(32, 2), (320, 2)])
def test_multihead_feature_embedding_matches_jax(question_dim, heads):
    from mmf_tpu.modules.embeddings import (
        MultiHeadImageFeatureEmbedding as JEmb,
    )
    from mmf_tpu_torch.modules.embeddings import (
        MultiHeadImageFeatureEmbedding,
    )
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    rng = np.random.RandomState(question_dim)
    image = rng.randn(3, 7, D).astype(np.float32)
    question = rng.randn(3, question_dim).astype(np.float32)

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, i, q):
            return JEmb(D, question_dim, heads, name="emb")(i, q, None)[0]

    variables = randomize(init_shapes(Flax(), jax.random.PRNGKey(0), image,
                                      question), 2)
    port = MultiHeadImageFeatureEmbedding(D, question_dim, heads)
    port.load_state_dict({k[len("emb."):]: v for k, v in params_from_jax(
        variables["params"]).items()}, strict=True)
    want = np.asarray(Flax().apply(variables, image, question))
    with torch.no_grad():
        got, attention = port(torch.from_numpy(image),
                              torch.from_numpy(question), None)
    assert attention is None and got.shape == (3, question_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_multihead_scores_match_jax(model):
    jm, variables = model
    tm = load(build("port", "multihead", MULTIHEAD), variables)
    b = batch(5)
    want = np.asarray(jm.apply(variables, tree_map(jnp.asarray, b),
                               False)["scores"])
    with torch.no_grad():
        got = tm(tree_map(torch.from_numpy, b))["scores"].numpy()
    assert got.shape == (B, ANSWERS) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert_round_trip(variables, tm)
    assert {n.split(".")[0] for n, _ in tm.named_parameters()} >= {
        "image_feature_embeddings_0_0", "FinetuneFasterRcnnFpnFc7_0"}


def test_multihead_gradients_match_jax(model):
    jm, variables = model
    tm = load(build("port", "multihead", MULTIHEAD), variables)
    b = batch(6)
    want, got = grads(jm, variables, tm, b, b, ["logit_bce"])
    assert_grads_match(want, got, GRAD_MIN_COSINE)


def test_multihead_adamax_trajectory_matches_jax(model, monkeypatch):
    # flax's LSTM cell starts its carry in its param_dtype (f32), which a
    # float64 scan cannot carry: in float64 it starts in float64
    init_carry = fnn.OptimizedLSTMCell.initialize_carry

    def carry64(self, rng, input_shape):
        return tuple(c.astype(jnp.float64)
                     for c in init_carry(self, rng, input_shape))

    monkeypatch.setattr(fnn.OptimizedLSTMCell, "initialize_carry", carry64)
    jm, variables = model
    tm = load(build("port", "multihead", MULTIHEAD), variables)
    b = batch(7)
    j_losses, t_losses, want = trajectory(jm, variables, tm, b, b,
                                          ["logit_bce"], f64=True)
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    assert len(set(np.round(t_losses, 6))) > 1  # the weights moved
    assert_params_match(tm, want)
