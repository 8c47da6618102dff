"""The Pythia family against the JAX package on the CPU: its pieces
(flax's ``OptimizedLSTMCell``, ``wn_dense`` with one gain and with a gain
an output, ``AttentionTextEmbedding``, ``ImageFeatureEmbedding``,
``ModalCombineLayer`` and ``LogitClassifier``) and ``pythia``,
``pythia_question_only`` and ``pythia_image_only`` from
``configs/models/pythia/defaults.yaml`` at small widths (text LSTM 16,
combine 20, classifier 24 / 12, 9 answers, 50 words, 7 regions x 16),
f32, dropout 0, on the same weights (a JAX init redrawn from a numpy
seed and carried across by ``params_from_jax``) and seeded numpy inputs:

- the scores within atol 2e-5;
- the step-0 gradients of the configured ``logit_bce`` at cosine >=
  0.99999 for every parameter (one whose gradient is 0 in exact
  arithmetic, below 1e-6 of the largest norm on both sides);
- 4 steps of the configs' optimizer (Adamax, warmup ``multi_step``,
  global-norm clipping at 0.25): the losses and every parameter within
  1e-5 relative (but the biases under a softmax, whose gradient is 0 in
  exact arithmetic: ``SHIFT_INVARIANT``);
- the weights' round trip through JAX's ``convert_torch_state_dict``.
"""

import flax.linen as fnn
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
from tests.torch_port_utils import tree_map

torch.set_num_threads(2)  # several test workers share the host

ATOL, GRAD_MIN_COSINE = 2e-5, 0.99999
V, T, K, D, ANSWERS, B = 50, 6, 7, 16, 9, 4
COMBINE = {"type": "non_linear_element_multiply",
           "params": {"dropout": 0, "hidden_dim": 20}}
OVERRIDES = {
    "text_vocab_size": V, "num_labels": ANSWERS, "image_feature_dim": D,
    "classifier": {"type": "logit", "params": {"img_hidden_dim": 24,
                                               "text_hidden_dim": 12}},
    "image_feature_embeddings": [{
        "modal_combine": COMBINE, "normalization": "softmax",
        "transform": {"type": "linear", "params": {"out_dim": 1}}}],
    "image_text_modal_combine": COMBINE,
    "text_embeddings": [{"type": "attention", "params": {
        "hidden_dim": 16, "num_layers": 1, "conv1_out": 8, "conv2_out": 2,
        "dropout": 0, "embedding_dim": 300, "kernel_size": 1,
        "padding": 0}}],
}
MODELS = ("pythia", "pythia_question_only", "pythia_image_only")


def batch(seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, V, (B, T)).astype(np.int64)
    text[1, 4:] = 0
    targets = np.zeros((B, ANSWERS), np.float32)
    targets[np.arange(B), rng.randint(ANSWERS, size=B)] = 1.0
    targets[0, 3] = 0.6
    return {"text": text,
            "image_feature_0": rng.randn(B, K, D).astype(np.float32),
            "image_info_0": {"max_features": np.array([7, 4, 5, 6])},
            "targets": targets}


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, redrawn variables, port model)."""
    out = {}
    for name in MODELS:
        jm = build("jax", name, OVERRIDES)
        variables = randomize(init_shapes(jm, jax.random.PRNGKey(0), tree_map(
            jnp.asarray, batch()), False), seed=1)
        out[name] = (jm, variables, load(build("port", name, OVERRIDES),
                                         variables))
    return out


def _apply(module, params, *args):
    return module.apply({"params": params}, *args)


def _flax_and_port(flax_module, port_module, *inputs, seed=0):
    """A flax module's redrawn init carried into the port module: (flax
    output, port output) on the same numpy inputs."""
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    j_in = [jnp.asarray(x) for x in inputs]
    variables = randomize(init_shapes(flax_module, jax.random.PRNGKey(seed),
                                      *j_in), seed + 1)
    port_module.load_state_dict(params_from_jax(variables["params"]),
                                strict=True)
    want = flax_module.apply(variables, *j_in)
    with torch.no_grad():
        got = port_module.eval()(*[torch.from_numpy(np.asarray(x))
                                   for x in inputs])
    return want, got


def test_lstm_cell_matches_flax():
    """flax ``OptimizedLSTMCell``'s eight products, gates i, f, g, o and
    the (c, h) carry; three steps, the carry fed back."""
    from mmf_tpu_torch.modules.layers import LSTMCell

    class Steps(fnn.Module):
        @fnn.compact
        def __call__(self, xs):
            cell = fnn.OptimizedLSTMCell(6, name="cell")
            carry = (jnp.zeros((3, 6)), jnp.zeros((3, 6)))
            outs = []
            for t in range(xs.shape[1]):
                carry, h = cell(carry, xs[:, t])
                outs.append(h)
            return jnp.stack(outs, 1), carry[0]

    class PortSteps(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cell = LSTMCell(5, 6)

        def forward(self, xs):
            carry = (xs.new_zeros(3, 6), xs.new_zeros(3, 6))
            outs = []
            for t in range(xs.shape[1]):
                carry, h = self.cell(carry, xs[:, t])
                outs.append(h)
            return torch.stack(outs, 1), carry[0]

    xs = np.random.RandomState(0).randn(3, 3, 5).astype(np.float32)
    (want_h, want_c), (got_h, got_c) = _flax_and_port(Steps(), PortSteps(),
                                                       xs)
    assert {n for n, _ in PortSteps().named_parameters()} == {
        f"cell.{k}{g}.{leaf}" for k in "ih" for g in "ifgo"
        for leaf in (("weight",) if k == "i" else ("weight", "bias"))}
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-6, rtol=0)


@pytest.mark.parametrize("per_output", [False, True])
def test_wn_dense_matches_flax(per_output):
    """``wn_dense``: flax ``WeightNorm`` over a Dense, one gain for the
    kernel (``feature_axes=None``) or one an output (``-1``); the port's
    gain keeps flax's name (``fc.Dense_0/kernel/scale``)."""
    from mmf_tpu.modules.layers import wn_dense
    from mmf_tpu_torch.modules.layers import add_wn_dense, apply_wn_dense

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return wn_dense(7, name="fc", scalar_norm=not per_output)(x)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            add_wn_dense(self, "fc", 0, 5, 7, per_output)

        def forward(self, x):
            return apply_wn_dense(self, "fc", x)

    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    port = Port()
    assert set(port.state_dict()) == {"fc.Dense_0/kernel/scale",
                                      "Dense_0.weight", "Dense_0.bias"}
    want, got = _flax_and_port(Flax(), port, x)
    assert tuple(port.fc.scale.shape) == ((7,) if per_output else ())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_attention_text_embedding_matches_jax():
    """The LSTM over the words, the two convolutions over time and the
    softmax-weighted glimpses; bidirectional too."""
    from mmf_tpu.modules.embeddings import (
        AttentionTextEmbedding as JEmbedding,
    )
    from mmf_tpu_torch.modules.embeddings import AttentionTextEmbedding

    x = np.random.RandomState(2).randn(3, T, 10).astype(np.float32)
    for bidirectional in (False, True):
        want, got = _flax_and_port(
            JEmbedding(12, 10, conv1_out=8, conv2_out=3, kernel_size=3,
                       padding=1, bidirectional=bidirectional),
            AttentionTextEmbedding(12, 10, conv1_out=8, conv2_out=3,
                                   kernel_size=3, padding=1,
                                   bidirectional=bidirectional), x)
        assert got.shape == (3, 36)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_image_feature_embedding_and_combine_match_jax():
    """Question-guided pooling of the regions (the combine layer inside,
    masked past each sample's region count and renormalised), and the
    combine layer alone on 2-D inputs."""
    from mmf_tpu.modules.embeddings import ImageFeatureEmbedding as JEmb
    from mmf_tpu.modules.layers import ModalCombineLayer as JCombine
    from mmf_tpu_torch.modules.embeddings import ImageFeatureEmbedding
    from mmf_tpu_torch.modules.layers import ModalCombineLayer

    rng = np.random.RandomState(3)
    image = rng.randn(3, K, D).astype(np.float32)
    question = rng.randn(3, 11).astype(np.float32)
    dims = np.array([7, 3, 5])
    transform = {"type": "linear", "params": {"out_dim": 2}}

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, i, q, d):
            return JEmb(D, 11, modal_combine=COMBINE, transform=transform,
                        name="emb")(i, q, d)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = ImageFeatureEmbedding(D, 11, COMBINE, transform)

        def forward(self, i, q, d):
            return self.emb(i, q, d)

    (want, want_attn), (got, got_attn) = _flax_and_port(
        Flax(), Port(), image, question, dims)
    assert got.shape == (3, 2 * D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_attn.numpy(), want_attn, atol=1e-6,
                               rtol=0)
    assert float(got_attn[1, 3:].abs().max()) == 0.0

    class FlaxCombine(fnn.Module):
        @fnn.compact
        def __call__(self, i, q):
            return JCombine(COMBINE["type"], 0, 0, COMBINE["params"],
                            name="c")(i, q)

    class PortCombine(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c = ModalCombineLayer(COMBINE["type"], D, 11,
                                       COMBINE["params"])

        def forward(self, i, q):
            return self.c(i, q)

    want, got = _flax_and_port(FlaxCombine(), PortCombine(), image[:, 0],
                               question)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("branch", [None, "text"])
def test_logit_classifier_matches_jax(branch):
    from mmf_tpu.modules.layers import LogitClassifier as JLogit
    from mmf_tpu_torch.modules.layers import ClassifierLayer

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return JLogit(ANSWERS, 12, 24, name="module")(x, branch=branch)

    port = ClassifierLayer("logit", 0, ANSWERS, {"text_hidden_dim": 12,
                                                 "img_hidden_dim": 24},
                           in_features=20, branch=branch)
    x = np.random.RandomState(4).randn(5, 20).astype(np.float32)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.module = port.module

        def forward(self, x):
            return self.module(x, branch=branch)

    want, got = _flax_and_port(Flax(), Port(), x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_pythia_scores_match_jax(models, name):
    jm, variables, tm = models[name]
    b = batch(5)
    want = np.asarray(jm.apply(variables, tree_map(jnp.asarray, b),
                               False)["scores"])
    with torch.no_grad():
        got = tm(tree_map(torch.from_numpy, b))["scores"].numpy()
    assert got.shape == (B, ANSWERS) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert_round_trip(variables, tm)


@pytest.mark.parametrize("name", MODELS)
def test_pythia_gradients_match_jax(models, name):
    jm, variables, _ = models[name]
    tm = load(build("port", name, OVERRIDES), variables)
    b = batch(6)
    want, got = grads(jm, variables, tm, b, b, ["logit_bce"])
    assert_grads_match(want, got, GRAD_MIN_COSINE)


@pytest.mark.parametrize("name", MODELS)
def test_pythia_adamax_trajectory_matches_jax(models, name):
    jm, variables, _ = models[name]
    tm = load(build("port", name, OVERRIDES), variables)
    b = batch(7)
    j_losses, t_losses, want = trajectory(jm, variables, tm, b, b,
                                          ["logit_bce"])
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    assert len(set(np.round(t_losses, 6))) > 1  # the weights moved
    assert_params_match(tm, want)
