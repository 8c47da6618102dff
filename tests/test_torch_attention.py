"""Port attention (mmf_tpu_torch/ops/attention.py) against the JAX
package: JAX's Pallas flash kernel in interpret mode and its XLA
``mha_reference``, on the same numpy inputs. On the CPU the port's
``dot_product_attention`` runs its plain version; the CUDA kernel is held
against that plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmf_tpu.ops import attention as jattn
from mmf_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)  # several test workers share the host

F32_ATOL = 1e-5   # same f32 algorithm, different summation order
BF16_ATOL = 2e-2  # bf16 inputs/outputs: one bf16 ulp at |x| ~ 1-4


def _inputs(seed, b, h, sq, skv, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, skv, d).astype(np.float32)
    v = rng.randn(b, h, skv, d).astype(np.float32)
    return rng, q, k, v


def _padding_mask(rng, b, skv):
    mask = (rng.rand(b, skv) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return mask


def _case(name):
    """(q, k, v, bias-or-None) numpy inputs for one named case."""
    if name == "no_bias":
        _, q, k, v = _inputs(0, 2, 2, 16, 16, 8)
        return q, k, v, None
    if name == "padding_mask":
        rng, q, k, v = _inputs(1, 2, 3, 12, 12, 16)
        return q, k, v, _padding_mask(rng, 2, 12)
    if name == "full_bias":
        rng, q, k, v = _inputs(2, 2, 2, 10, 10, 8)
        return q, k, v, rng.randn(2, 1, 10, 10).astype(np.float32)
    if name == "head_bias":
        rng, q, k, v = _inputs(3, 1, 3, 7, 7, 8)
        return q, k, v, rng.randn(1, 3, 7, 7).astype(np.float32)
    if name == "sq_ne_skv":
        rng, q, k, v = _inputs(4, 2, 2, 9, 21, 8)
        return q, k, v, _padding_mask(rng, 2, 21)
    if name == "d64_ragged_37":
        rng, q, k, v = _inputs(5, 1, 2, 37, 37, 64)
        return q, k, v, _padding_mask(rng, 1, 37)
    if name == "user_masked_row":
        # one q row masked at every column with the finite mask value and
        # one batch whose padding mask is all zero: both give a uniform
        # softmax (finite mask), in JAX's flash kernel and reference alike
        rng, q, k, v = _inputs(6, 2, 2, 6, 6, 8)
        bias = np.zeros((2, 1, 6, 6), np.float32)
        bias[0, 0, 3, :] = jattn.DEFAULT_MASK_VALUE
        bias[1] = jattn.DEFAULT_MASK_VALUE
        return q, k, v, bias
    raise KeyError(name)


CASES = ["no_bias", "padding_mask", "full_bias", "head_bias", "sq_ne_skv",
         "d64_ragged_37", "user_masked_row"]


def _biases(bias_np, dtype_j, dtype_t):
    """JAX and port biases from a mask ([B, Skv] int) or a float bias."""
    if bias_np is None:
        return None, None
    if bias_np.ndim == 2:  # padding mask -> make_attention_bias
        jb = jattn.make_attention_bias(jnp.asarray(bias_np), dtype_j)
        tb = tattn.make_attention_bias(torch.from_numpy(bias_np), dtype_t)
        np.testing.assert_array_equal(
            np.asarray(jb.astype(jnp.float32)), tb.float().numpy()
        )
        return jb, tb
    return jnp.asarray(bias_np), torch.from_numpy(bias_np)


@pytest.mark.parametrize("case", CASES)
def test_attention_f32_matches_jax(case, monkeypatch):
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    q, k, v, bias_np = _case(case)
    jb, tb = _biases(bias_np, jnp.float32, torch.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    flash = np.asarray(jattn.flash_attention(jq, jk, jv, jb, interpret=True))
    ref = np.asarray(jattn.mha_reference(jq, jk, jv, jb))
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tb
    ).numpy()
    assert got.shape == q.shape[:3] + (q.shape[3],)
    np.testing.assert_allclose(got, flash, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["padding_mask", "sq_ne_skv"])
def test_attention_bf16_matches_jax(case, monkeypatch):
    # JAX's reference stores bf16 logits by default; pin f32 logits so
    # both sides run the same algorithm and differ only by bf16 rounding
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    q, k, v, bias_np = _case(case)
    jb, tb = _biases(bias_np, jnp.bfloat16, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    flash = np.asarray(
        jattn.flash_attention(jq, jk, jv, jb, interpret=True), np.float32
    )
    ref = np.asarray(jattn.mha_reference(jq, jk, jv, jb), np.float32)
    got = tattn.dot_product_attention(tq, tk, tv, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), flash, atol=BF16_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=BF16_ATOL,
                               rtol=0)


def test_combined_masks_give_zero_rows_not_nan(monkeypatch):
    """combine_biases of two finite masks overflows to -inf in f32; a row
    that is -inf everywhere must come out as zeros. JAX's flash kernel and
    reference give NaN there (ROADMAP section C); every other row must
    match them."""
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    _, q, k, v = _inputs(7, 2, 2, 5, 7, 8)
    mask = np.ones((2, 7), np.int32)
    mask[1] = 0  # batch 1: every column masked by both masks
    jm = jattn.make_attention_bias(jnp.asarray(mask), jnp.float32)
    tm = tattn.make_attention_bias(torch.from_numpy(mask), torch.float32)
    jb, tb = jattn.combine_biases(jm, jm), tattn.combine_biases(tm, tm)
    assert torch.isneginf(tb[1]).all()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    flash = np.asarray(jattn.flash_attention(jq, jk, jv, jb, interpret=True))
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tb
    ).numpy()
    assert np.all(got[1] == 0.0)
    np.testing.assert_allclose(got[0], flash[0], atol=F32_ATOL, rtol=0)
    assert np.isnan(flash[1]).all()  # the JAX divergence this pins


def test_dropout_routes_to_plain_version_and_uses_the_generator():
    _, q, k, v = _inputs(8, 1, 2, 6, 6, 8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tattn.dot_product_attention(tq, tk, tv, dropout_rate=0.5,
                                           generator=g)

    plain = tattn.dot_product_attention(tq, tk, tv)
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.allclose(run(3), plain)
    # without a generator dropout is off, as in JAX without an rng
    torch.testing.assert_close(
        tattn.dot_product_attention(tq, tk, tv, dropout_rate=0.5), plain,
        rtol=0, atol=0,
    )


@pytest.mark.parametrize("d,padded", [(1, 8), (4, 8), (8, 8), (12, 16),
                                      (64, 64), (121, 128), (128, 128),
                                      (0, None), (136, None), (256, None)])
def test_padded_head_dim(d, padded):
    """The head dim the kernels run a head dim at (a multiple of 8), and
    the head dims they refuse."""
    if padded is None:
        with pytest.raises(ValueError, match="head dims 1 to 128"):
            tattn.padded_head_dim(d)
    else:
        assert tattn.padded_head_dim(d) == padded


@pytest.mark.parametrize("d", [12, 36])
def test_zero_padded_head_dim_matches_jax(d, monkeypatch):
    """What the card computes for a head dim that is not a multiple of 8:
    the plain version on q, k and v zero-padded by ``pad_head_dim``, at
    the scale of the true head dim, cut back to it, against JAX at the
    true head dim (the padded columns add nothing to the scores)."""
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    rng, q, k, v = _inputs(5, 2, 2, 9, 11, d)
    bias_np = (1.0 - _padding_mask(rng, 2, 11)[:, None, None, :]) * -1e9
    bias_np = bias_np.astype(np.float32)
    want = np.asarray(jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v, bias_np)), impl="xla"))
    padded = tattn.pad_head_dim(*map(torch.from_numpy, (q, k, v)))
    assert all(t.shape[-1] == tattn.padded_head_dim(d) for t in padded)
    assert all(not t[..., d:].any() for t in padded)
    got = tattn.mha_reference(*padded, torch.from_numpy(bias_np),
                              d ** -0.5)[..., :d].numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(tattn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v, bias_np))).numpy(), want,
        atol=F32_ATOL, rtol=0)
