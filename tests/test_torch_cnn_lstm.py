"""CNN-LSTM against the JAX package on the CPU: ``ConvNet`` (conv, leaky
ReLU, max pool, BatchNorm with flax's statistics) in training and eval
mode, and ``cnn_lstm`` from its Hateful Memes project config
(``projects/others/cnn_lstm/hateful_memes/defaults.yaml``: a
bidirectional LSTM of 50 over 20-wide words, six ConvNets, the ``mlp``
classifier, ``cross_entropy``, AdamW) over 64 px images, f32, on the
same weights (``tests/torch_hm_models.py``: numpy draws into JAX's
shapes, the BatchNorm statistics random):

- the eval scores within atol 2e-5;
- the step-0 gradients at cosine >= 0.99999 and a 4-step AdamW
  trajectory in training mode (the BatchNorm statistics move) within
  ``torch_hm_models.assert_trajectory``'s bounds, in float64 on both
  sides;
- the weights' round trip through JAX's ``convert_torch_state_dict``,
  the BatchNorm statistics included (their names mapped to flax's
  ``mean`` and ``var``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_hm_models as hm
from tests.torch_caption_models import assert_grads_match

torch.set_num_threads(2)  # several test workers share the host

IMAGE = 64  # six pools of 2 leave 1 x 1
STATS_KEY_MAP = {r"running_mean$": "mean", r"running_var$": "var"}


@pytest.fixture(scope="module")
def pair():
    return hm.Pair("cnn_lstm", seed=2, image=IMAGE)


def assert_round_trip(variables, state):
    """The port's parameters through JAX's ``convert_torch_state_dict``
    onto the params, its BatchNorm statistics onto ``batch_stats``: every
    flax leaf matched, none missed, bit-equal."""
    from mmf_tpu.utils.checkpoint_updater import (
        _flatten_flax,
        convert_torch_state_dict,
    )

    state = {k: v.numpy() for k, v in state.items()
             if not k.endswith("num_batches_tracked")}
    stats_keys = {k for k in state if k.endswith(("running_mean",
                                                   "running_var"))}
    for collection, keys, key_map in (
            ("params", set(state) - stats_keys, None),
            ("batch_stats", stats_keys, STATS_KEY_MAP)):
        tree = jax.device_get(variables[collection])
        zeros = jax.tree_util.tree_map(np.zeros_like, tree)
        converted, stats = convert_torch_state_dict(
            {k: state[k] for k in keys}, zeros, key_map)
        want, got = _flatten_flax(tree), _flatten_flax(converted)
        assert stats == {"matched": len(want), "missed": 0,
                         "shape_mismatch": 0}, collection
        for path in want:
            np.testing.assert_array_equal(np.asarray(got[path]),
                                          np.asarray(want[path]),
                                          err_msg="/".join(path))


@pytest.mark.parametrize("train", [False, True])
def test_convnet_matches_flax(train):
    """One ConvNet (kernel 5, "same" padding, an odd size so that the
    pool floors) on both sides; in training mode the batch's statistics
    normalise and the running ones move as flax moves them."""
    from mmf_tpu.modules.layers import ConvNet as JConvNet
    from mmf_tpu_torch.modules.layers import ConvNet
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    rng = np.random.RandomState(3)
    x = rng.randn(3, 4, 9, 11).astype(np.float32)
    jm = JConvNet(6, 5)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    variables = {
        "params": jax.tree_util.tree_map(
            lambda a: (0.2 * rng.randn(*a.shape)).astype(np.float32),
            variables["params"]),
        "batch_stats": {"norm": {
            "mean": (0.1 * rng.randn(6)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}}
    tm = ConvNet(4, 6, 5)
    tm.load_state_dict(params_from_jax(variables["params"],
                                       variables["batch_stats"]),
                       strict=True)
    assert_round_trip(variables, tm.state_dict())
    if train:
        want, new = jm.apply(variables, jnp.asarray(x), False,
                             mutable=["batch_stats"])
    else:
        want, new = jm.apply(variables, jnp.asarray(x), True), None
    got = tm.train(train)(torch.from_numpy(x)).detach()
    assert got.shape == (3, 6, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    if train:
        stats = new["batch_stats"]["norm"]
        np.testing.assert_allclose(tm.norm.running_mean.numpy(),
                                   stats["mean"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(tm.norm.running_var.numpy(),
                                   stats["var"], atol=1e-6, rtol=1e-6)


def test_cnn_lstm_scores_match_jax(pair):
    got, want = pair.forwards()
    assert got.shape == (hm.B, 32)  # num_labels: HM registers no answers
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert_round_trip(pair.variables, pair.tm.state_dict())
    assert tuple(pair.tm.classifier.module.out.weight.shape) == (32, 110)


def test_cnn_lstm_trains_as_jax(monkeypatch):
    """In float64 on both sides, as the Hateful Memes baselines: a conv
    bias whose channel the leaky ReLU and the pool pass linearly is
    taken back out by the BatchNorm's batch mean, its gradient 0 in
    exact arithmetic, and Adam would step its f32 noise either way.
    flax's LSTM cell starts its carry in its param_dtype (f32), which a
    float64 scan cannot carry: here it starts in float64."""
    init_carry = fnn.OptimizedLSTMCell.initialize_carry

    def carry64(self, rng, input_shape):
        return tuple(c.astype(jnp.float64)
                     for c in init_carry(self, rng, input_shape))

    monkeypatch.setattr(fnn.OptimizedLSTMCell, "initialize_carry", carry64)
    with hm.x64():
        trained = hm.train_both(hm.Pair("cnn_lstm", seed=2, f64=True,
                                        image=IMAGE))
    want, got = trained["grads"]
    assert_grads_match(want, got, 0.99999)
    hm.assert_trajectory(trained)
