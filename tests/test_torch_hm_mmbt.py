"""MMBT on the Hateful Memes config (``projects/hateful_memes/configs/
mmbt/defaults.yaml``: ResNet-152 grid features trained with their
BatchNorm statistics, cross entropy over 2 labels, BERT's no-decay
groups) in the port against the JAX package on the CPU, at a small size
(``tests/torch_hm_models.py``): the f32 eval forward within the repo's
2e-5, the step-0 gradients, and a 4-step AdamW trajectory whose losses,
weights and BatchNorm statistics follow JAX's (in float64 on both sides there:
``tests/torch_hm_models.py`` says why)."""

import numpy as np
import pytest
import torch

from tests import torch_hm_models as hm

torch.set_num_threads(2)  # several test workers share the host

KEYS = ["mmbt"]
F32_ATOL = 2e-5  # the repo's own parity bar (README)
GRAD_REL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _jax_no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(*hm.jax_no_dropout())
        yield


@pytest.fixture(scope="module", params=KEYS)
def pair(request):
    return hm.Pair(request.param)


@pytest.fixture(scope="module", params=KEYS)
def trained(request):
    with hm.x64():
        return hm.train_both(hm.Pair(request.param, f64=True))


def test_forward_matches_jax(pair):
    got, want = pair.forwards()
    assert got.shape == want.shape == (hm.B, 2)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_step0_gradients_match_jax(trained):
    want, got = trained["grads"]
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        err = hm.rel_err(got[name], want[name], floor)
        assert err < GRAD_REL, f"gradient mismatch at {name}: rel {err:.2e}"


def test_trajectory_matches_jax(trained):
    hm.assert_trajectory(trained)
    # the statistics moved: training mode updates them
    stats = trained["model"].state_dict()
    assert int(stats["ResNet152ImageEncoder_0.model.bn1"
                     ".num_batches_tracked"]) == 4


def test_weight_decay_mask_matches_jax(pair):
    """The port's no-decay groups are JAX's, BatchNorm scales included:
    JAX's mask exempts every flax ``scale`` leaf."""
    import jax

    from mmf_tpu_torch.utils.checkpoint_updater import _LEAF

    jax_mask = pair.jm.get_weight_decay_mask(None)(pair.variables["params"])
    want = {}
    for path, decay in jax.tree_util.tree_flatten_with_path(jax_mask)[0]:
        keys = [p.key for p in path]
        want[".".join(keys[:-1] + [_LEAF[keys[-1]]])] = bool(decay)
    got = pair.tm.get_weight_decay_mask(None)(pair.tm)
    assert got == want
    assert not got["ResNet152ImageEncoder_0.model.bn1.weight"]
    assert got["ResNet152ImageEncoder_0.model.conv1.weight"]
