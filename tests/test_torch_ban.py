"""BAN against the JAX package on the CPU: its pieces (flax's ``GRUCell``
and ``OptimizedLSTMCell`` through ``BiLSTMTextEmbedding``, one and two
layers, one direction and both; ``FCNet``; ``BCNet`` in each of its
forms; ``BiAttention`` over regions some of which are all zeros) and
``ban`` from ``configs/models/ban/defaults.yaml`` at small widths (a GRU
of 12, 2 glimpses, 9 answers, 50 words, 7 regions x 16), f32, dropout
0, on the same weights (a JAX init redrawn from a numpy seed and carried
across by ``params_from_jax``) and seeded numpy inputs:

- the scores within atol 2e-5;
- the step-0 gradients of the configured ``logit_bce`` at cosine >=
  0.99999 for every parameter;
- 4 steps of Adamax (warmup ``multi_step``, global-norm clipping at
  0.25): the losses and every parameter within 1e-5 relative (but the
  attention's ``h_bias``, one constant a glimpse under its softmax,
  whose gradient is 0 in exact arithmetic);
- the weights' round trip through JAX's ``convert_torch_state_dict``.

BCNet's rates of dropout (0.2 and 0.5) are read from no config key, in
either package: the model tests set them to 0 on both sides
(``ban_no_dropout``).
"""

from typing import Optional, Sequence

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_caption_models import (
    SHIFT_INVARIANT,
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
V, T, K, D, ANSWERS, B, HIDDEN = 50, 5, 7, 16, 9, 4, 12
OVERRIDES = {
    "text_vocab_size": V, "num_labels": ANSWERS,
    "text_embedding": {"num_hidden": HIDDEN, "emb_size": 300,
                       "num_layers": 1, "dropout": 0.0,
                       "bidirectional": False, "rnn_type": "GRU"},
    "bilinear_attention": {"bc_net": {"k": 1}, "gamma": 2,
                           "visual_feat_dim": D,
                           "fc_net": {"activation": "ReLU", "dropout": 0.0}},
    "classifier": {"dropout": 0.0},
}


def ban_no_dropout(mp):
    """BCNet's rates of dropout to 0 in both packages (JAX's model builds
    its BCNets and BiAttention with the defaults)."""
    import mmf_tpu.models.ban as jban
    from mmf_tpu.modules import layers as jlayers
    from mmf_tpu_torch.modules import layers

    class BCNet(jlayers.BCNet):
        dropout: Optional[Sequence[float]] = (0.0, 0.0)

    class BiAttention(jlayers.BiAttention):
        dropout: Optional[Sequence[float]] = (0.0, 0.0)

    mp.setattr(jban, "BCNet", BCNet)
    mp.setattr(jban, "BiAttention", BiAttention)
    mp.setattr(jlayers, "BCNet", BCNet)
    mp.setattr(layers, "BCNET_DROPOUT", (0.0, 0.0))


def batch(seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, V, (B, T)).astype(np.int64)
    text[1, 3:] = 0
    image = rng.randn(B, K, D).astype(np.float32)
    image[2, 5:] = 0.0  # regions past the image's boxes are zeros
    targets = np.zeros((B, ANSWERS), np.float32)
    targets[np.arange(B), rng.randint(ANSWERS, size=B)] = 1.0
    targets[0, 3] = 0.6
    return {"text": text, "image_feature_0": image, "targets": targets}


@pytest.fixture(scope="module")
def model():
    """(JAX model, redrawn variables, port model), dropout 0."""
    with pytest.MonkeyPatch.context() as mp:
        ban_no_dropout(mp)
        jm = build("jax", "ban", OVERRIDES)
        variables = randomize(init_shapes(jm, jax.random.PRNGKey(0), tree_map(
            jnp.asarray, batch()), False), seed=1)
        tm = load(build("port", "ban", OVERRIDES), variables)
        yield jm, variables, tm


def _flax_and_port(flax_module, port_module, *inputs, seed=0, **kwargs):
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    j_in = [jnp.asarray(x) for x in inputs]
    variables = randomize(init_shapes(flax_module, jax.random.PRNGKey(seed),
                                      *j_in, **kwargs), seed + 1)
    port_module.load_state_dict(params_from_jax(variables["params"]),
                                strict=True)
    want = flax_module.apply(variables, *j_in, **kwargs)
    with torch.no_grad():
        got = port_module.eval()(*[torch.from_numpy(np.asarray(x))
                                   for x in inputs], **kwargs)
    return want, got, variables


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_recurrent_text_embedding_matches_flax(rnn_type, bidirectional):
    """Two layers of flax's cells over every step of the padded length
    (the backward cell run from the last step, its outputs in order):
    every step's output and the last step's; the port's parameter names
    are flax's (``rnn_<layer>_<fwd|bwd>.<ir|...|ho>``)."""
    from mmf_tpu.modules.embeddings import BiLSTMTextEmbedding as JEmb
    from mmf_tpu_torch.modules.embeddings import BiLSTMTextEmbedding

    x = np.random.RandomState(2).randn(3, 6, 10).astype(np.float32)
    port = BiLSTMTextEmbedding(8, 10, 2, 0.0, bidirectional, rnn_type)
    want, got, variables = _flax_and_port(
        JEmb(8, 10, 2, 0.0, bidirectional, rnn_type), port, x,
        forward_all=True)
    assert got.shape == (3, 6, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # without forward_all JAX returns the last step, both ways
    with torch.no_grad():
        last = port(torch.from_numpy(x))
    assert last.shape == (3, 8)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1],
                               atol=1e-6, rtol=0)
    assert_round_trip(variables, port)
    gates = "rzn" if rnn_type == "GRU" else "ifgo"
    assert {n.split(".")[1][1] for n, _ in port.named_parameters()} == set(
        gates)


@pytest.mark.parametrize("form", ["weights", "products", "h_mat", "h_net"])
def test_bcnet_matches_jax(form):
    """``BCNet`` in its forms: given the attention maps ``w`` (k 3: the
    slices averaged), without ``h_out`` (the products), with ``h_out`` 4
    (``h_mat`` and ``h_bias``) and 40 (``h_net``)."""
    from mmf_tpu.modules.layers import BCNet as JBCNet
    from mmf_tpu_torch.modules.layers import BCNet

    rng = np.random.RandomState(3)
    v = rng.randn(2, 4, 5).astype(np.float32)
    q = rng.randn(2, 3, 7).astype(np.float32)
    h_out = {"weights": None, "products": None, "h_mat": 4, "h_net": 40}[form]
    inputs = (v, q)
    if form == "weights":
        w = rng.rand(2, 4, 3).astype(np.float32)
        inputs = (v, q, True, w)

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, *a):
            return JBCNet(6, h_out, k=3, name="net")(*a)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = BCNet(5, 7, 6, h_out, k=3)

        def forward(self, v, q, deterministic=None, w=None):
            return self.net(v, q, w=w)

    port = Port()
    want, got, variables = _flax_and_port(Flax(), port, *inputs)
    shape = {"weights": (2, 6), "products": (2, 4, 3, 18),
             "h_mat": (2, 4, 4, 3), "h_net": (2, 40, 4, 3)}[form]
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    assert_round_trip(variables, port)


def test_biattention_masks_zero_regions_as_jax():
    from mmf_tpu.modules.layers import BiAttention as JBiAttention
    from mmf_tpu_torch.modules.layers import BiAttention

    rng = np.random.RandomState(4)
    v = rng.randn(3, 5, 6).astype(np.float32)
    v[1, 3:] = 0.0
    q = rng.randn(3, 4, 8).astype(np.float32)

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, v, q):
            return JBiAttention(7, 2, name="att")(v, q)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.att = BiAttention(6, 8, 7, 2)

        def forward(self, v, q):
            return self.att(v, q)

    (want_p, want_l), (got_p, got_l), _ = _flax_and_port(Flax(), Port(), v,
                                                         q)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(np.isinf(got_l.numpy()),
                                  np.isinf(np.asarray(want_l)))
    assert float(got_p[1, :, 3:].abs().max()) == 0.0
    np.testing.assert_allclose(got_p.sum(dim=(2, 3)).numpy(), 1.0, atol=1e-6)


def test_ban_scores_match_jax(model):
    jm, variables, tm = model
    b = batch(5)
    want = np.asarray(jm.apply(variables, tree_map(jnp.asarray, b),
                               False)["scores"])
    with torch.no_grad():
        got = tm(tree_map(torch.from_numpy, b))["scores"].numpy()
    assert got.shape == (B, ANSWERS) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert_round_trip(variables, tm)


def test_ban_gradients_and_trajectory_match_jax(model):
    jm, variables, _ = model
    with pytest.MonkeyPatch.context() as mp:
        ban_no_dropout(mp)
        tm = load(build("port", "ban", OVERRIDES), variables)
        b = batch(6)
        want, got = grads(jm, variables, tm, b, b, ["logit_bce"])
        assert_grads_match(want, got, GRAD_MIN_COSINE)
        b = batch(7)
        j_losses, t_losses, want = trajectory(jm, variables, tm, b, b,
                                              ["logit_bce"])
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    assert len(set(np.round(t_losses, 6))) > 1  # the weights moved
    # h_bias adds one constant to a glimpse's logits under its softmax:
    # its gradient is 0 in exact arithmetic
    assert_params_match(tm, want, skip=SHIFT_INVARIANT + ("h_bias",))
