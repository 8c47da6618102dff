"""The unimodal baselines of Hateful Memes (``unimodal_text`` from
``unimodal/text.yaml``, a summed vocabulary embedding, and from
``unimodal/bert.yaml``, BERT under a 2-layer MLP classifier;
``unimodal_image`` from ``unimodal/image.yaml``, ResNet-152 under a
2-layer MLP with BatchNorm) in the port against the JAX package on the
CPU, at a small size (``tests/torch_hm_models.py``): the f32 eval
forward within the repo's 2e-5, the step-0 gradients and a 4-step AdamW
trajectory (the MLP's and the ResNet's BatchNorm statistics included;
float64 on both sides), and ``unimodal_image``'s direct-features branch,
which mean-pools the regions first."""

import numpy as np
import pytest
import torch

from tests import torch_hm_models as hm

torch.set_num_threads(2)  # several test workers share the host

F32_ATOL = 2e-5  # the repo's own parity bar (README)
GRAD_REL = 5e-4
CASES = [("unimodal_text", False), ("unimodal_text_bert", False),
         ("unimodal_image", False), ("unimodal_image", True)]


@pytest.fixture(scope="module", autouse=True)
def _jax_no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(*hm.jax_no_dropout())
        yield


@pytest.mark.parametrize("key,direct", CASES)
def test_forward_matches_jax(key, direct):
    got, want = hm.Pair(key, direct=direct).forwards()
    assert got.shape == want.shape == (hm.B, 2)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{k}-{'direct' if d else 'raw'}" for k, d in CASES])
def trained(request):
    key, direct = request.param
    with hm.x64():
        return hm.train_both(hm.Pair(key, f64=True, direct=direct))


def test_step0_gradients_match_jax(trained):
    want, got = trained["grads"]
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        err = hm.rel_err(got[name], want[name], floor)
        assert err < GRAD_REL, f"gradient mismatch at {name}: rel {err:.2e}"


def test_trajectory_matches_jax(trained):
    hm.assert_trajectory(trained)
    stats = [k for k in trained["jax_state"] if k.endswith("running_var")]
    assert ("classifier.module.norm_1.running_var" in stats) == (
        trained["model"].config["classifier"]["params"].get(
            "num_layers", 0) >= 2)
