"""K1's raw-stats form (the ring-attention block state) against the JAX
package: the port's plain version ``flash_attention_block_reference``
against JAX's ``flash_attention_block(..., interpret=True)`` (the Pallas
kernel with ``raw_stats=True`` in interpret mode), on the cases of
tests/test_torch_attention_backward.py; ``merge_block_states`` over 2-3 kv
blocks against attention over the whole kv; and the row with no finite
score, where the port gives the empty state (m = -inf, l = 0, acc = 0) and
JAX gives NaN. The CUDA kernel is held against the plain version on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmf_tpu.ops import attention as jattn
from mmf_tpu_torch.ops import attention as tattn
from tests.test_torch_attention_backward import CASES, DTYPES, _case, _to_both

torch.set_num_threads(2)  # several test workers share the host

# acc relative to its largest entry. f32: the same products in another
# order; bf16: the port rounds the probabilities to bf16 before p v (as
# its kernel does), JAX's interpret mode keeps them in f32 (one bf16 ulp is
# 2^-8 relative). m and l are f32 sums of f32 scores on both sides.
ACC_REL = {"float32": 2e-5, "bfloat16": 2e-2}
STATS_RTOL = 1e-5


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_raw_stats_form_matches_jax(case, dtype, monkeypatch):
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    q, k, v, bias_np, dout = _case(case)
    (jq, jk, jv, _), jb, (tq, tk, tv, _), tb = _to_both(q, k, v, bias_np,
                                                        dout, dtype)
    j_acc, j_m, j_l = jattn.flash_attention_block(jq, jk, jv, jb,
                                                  interpret=True)
    acc, m, l = tattn.flash_attention_block_reference(tq, tk, tv, tb)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert acc.shape == q.shape and m.shape == l.shape == q.shape[:3]
    np.testing.assert_allclose(m.numpy(), np.asarray(j_m), rtol=STATS_RTOL,
                               atol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(j_l), rtol=STATS_RTOL,
                               atol=1e-6)
    err = _rel_err(acc.numpy(), j_acc)
    assert err < ACC_REL[dtype], f"acc rel {err:.2e}"


def _split(n, parts):
    edges = np.linspace(0, n, parts + 1).astype(int)
    return [slice(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("parts", [2, 3])
def test_merged_blocks_equal_attention_over_the_whole_kv(parts, dtype,
                                                         monkeypatch):
    """The states of 2-3 disjoint kv blocks, merged by the ring
    recurrence, give the attention over the whole kv: against the port's
    mha_reference and JAX's flash_attention (interpret mode)."""
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    q, k, v, mask, dout = _case("q64_kv200_d32")
    (jq, jk, jv, _), jb, (tq, tk, tv, _), tb = _to_both(q, k, v, mask, dout,
                                                        dtype)
    skv = k.shape[2]
    states = [tattn.flash_attention_block_reference(
        tq, tk[:, :, sl], tv[:, :, sl], tb[..., sl])
        for sl in _split(skv, parts)]
    acc, m, l = tattn.merge_block_states(states)
    whole = tattn.flash_attention_block_reference(tq, tk, tv, tb)
    torch.testing.assert_close(m, whole[1], rtol=0, atol=0)
    torch.testing.assert_close(l, whole[2], rtol=STATS_RTOL, atol=0)
    out = (acc / l[..., None]).numpy()
    want = tattn.mha_reference(tq, tk, tv, tb).float().numpy()
    assert _rel_err(out, want) < ACC_REL[dtype]
    j_out = jattn.flash_attention(jq, jk, jv, jb, interpret=True)
    assert _rel_err(out, j_out) < ACC_REL[dtype]


def test_row_without_a_finite_score_is_the_empty_state():
    """Two combined masks overflow to -inf: the port's state there is (m =
    -inf, l = 0, acc = 0), which the merge treats as empty, where JAX
    gives NaN; every other row matches JAX."""
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(2, 2, 5, 8).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 5), np.int32)
    mask[1] = 0
    jm = jattn.make_attention_bias(jnp.asarray(mask))
    tm = tattn.make_attention_bias(torch.from_numpy(mask))
    jb, tb = jattn.combine_biases(jm, jm), tattn.combine_biases(tm, tm)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    acc, m, l = tattn.flash_attention_block_reference(tq, tk, tv, tb)
    assert torch.isneginf(m[1]).all() and (l[1] == 0).all()
    assert (acc[1] == 0).all()
    j_acc, j_m, j_l = jattn.flash_attention_block(
        *map(jnp.asarray, (q, k, v)), jb, interpret=True)
    assert np.isnan(np.asarray(j_acc[1])).any()  # the JAX divergence
    np.testing.assert_allclose(acc[0].numpy(), np.asarray(j_acc[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m[0].numpy(), np.asarray(j_m[0]), rtol=1e-6)
    np.testing.assert_allclose(l[0].numpy(), np.asarray(j_l[0]), rtol=1e-6)
    # merging the empty state with a real one gives the real one, bit for
    # bit, in either order
    real = tattn.flash_attention_block_reference(tq[:1], tk[:1], tv[:1])
    empty = (acc[1:], m[1:], l[1:])
    for states in ((empty, real), (real, empty)):
        merged = tattn.merge_block_states(states)
        for got, want in zip(merged, real):
            assert torch.equal(got, want)


def test_raw_stats_kernel_needs_the_card():
    """On CPU tensors the kernel wrapper refuses instead of running the
    plain version, and counts no launch."""
    q = torch.zeros(1, 2, 8, 8)
    before = tattn.flash_attention_block.launches
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tattn.flash_attention_block(q, q, q)
    assert tattn.flash_attention_block.launches == before
