"""The int8 path of the port (``mmf_tpu_torch/ops/quant.py``) against the
JAX package's ``mmf_tpu/ops/quant.py`` on the CPU: quantisation bit for
bit, the plain version of the int8 GEMM (K5) against JAX's XLA path,
the straight-through gradients against ``jax.vjp``, and the knob's
invariance of the parameter names. The kernel itself runs only on the
card (``tests/test_torch_cuda_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu.ops import quant as jq
from mmf_tpu_torch.ops import quant as tq

torch.set_num_threads(2)  # several test workers share the host

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rows_with_ties(seed, dtype):
    """[6, 64] rows: random ones, an all-zero row (the eps path), and rows
    whose amax is 127 (scale exactly 1) holding exact .5 ties, which round
    half to even."""
    rng = np.random.RandomState(seed)
    x = rng.randn(6, 64).astype(np.float32)
    x[1] = 0.0
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[3, :4] = [-127.0, 3.5, -4.5, 100.5]
    x[4] *= 1e-9  # below eps 1e-6: the scale is eps / 127
    return np.array(jnp.asarray(x, DTYPES[dtype][0]).astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_rows_and_cols_are_bit_equal_to_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _rows_with_ties(0, dtype)
    for jfn, tfn, arr in ((jq.quantize_rows, tq.quantize_rows, x),
                          (jq.quantize_cols, tq.quantize_cols, x.T.copy())):
        want_q, want_s = jfn(jnp.asarray(arr, jdt))
        got_q, got_s = tfn(torch.from_numpy(arr).to(tdt))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    q, s = tq.quantize_rows(torch.from_numpy(x))
    assert q[2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert (q[1] == 0).all() and float(s[1, 0]) == np.float32(1e-6) / 127
    # the port's [N, K] weight, quantised per row, gives JAX's per-column
    # integers and scales of the [K, N] kernel
    wq, ws = tq.quantize_rows(torch.from_numpy(x), eps=1e-11)
    jwq, jws = jq.quantize_cols(jnp.asarray(x.T))
    np.testing.assert_array_equal(wq.numpy().T, np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy().T, np.asarray(jws))


# f32 output: the same integers and scales, and the epilogue y * (xs ws)
# + b rounded step by step on both sides; 2 ulp allows XLA to contract
# the last multiply-add. bf16 output: within one bf16 ulp (2^-8 relative)
TOL = {"float32": dict(rtol=2.4e-7, atol=1e-6),
       "bfloat16": dict(rtol=2 ** -8, atol=1e-6)}


@pytest.mark.parametrize("m", [1, 131])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dequant_gemm_reference_matches_jax_int8_dense(m, dtype):
    jdt, tdt = DTYPES[dtype]
    k, n = 64, 48
    rng = np.random.RandomState(m)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), out_dtype=jdt),
                      np.float32)

    xt, wt = torch.from_numpy(x), torch.from_numpy(w.T.copy())
    x8, xs = tq.quantize_rows(xt)
    w8, ws = tq.quantize_rows(wt, eps=1e-11)
    got = tq.dequant_gemm_reference(x8, w8, xs.reshape(-1), ws.reshape(-1),
                                    torch.from_numpy(b), tdt)
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    # the entry point takes the plain version for CPU tensors
    via_dense = tq.int8_dense(xt, wt, torch.from_numpy(b), tdt)
    assert torch.equal(via_dense, got)


def test_int8_dense_batched_and_matmul_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 32).astype(np.float32)
    w = rng.randn(32, 16).astype(np.float32)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    assert got.shape == (2, 5, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


def test_straight_through_gradients_match_jax_vjp():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 4, 24).astype(np.float32)
    w = rng.randn(24, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    g = rng.randn(3, 4, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_, b_: jq.int8_dense(x_, w_, b_),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    wgx, wgw, wgb = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    tq.int8_dense(xt, wt, bt).backward(torch.from_numpy(g))
    # exact f32 matmuls on both sides, other summation orders
    for got, want in ((xt.grad, wgx), (wt.grad.T, wgw), (bt.grad, wgb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_dequant_gemm_refuses_cpu_tensors_and_bad_k():
    x8 = torch.zeros(3, 24, dtype=torch.int8)
    w8 = torch.zeros(5, 24, dtype=torch.int8)
    xs, ws = torch.ones(3), torch.ones(5)
    before = tq.dequant_gemm.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        tq.dequant_gemm(x8, w8, xs, ws, None)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tq.dequant_gemm(x8[:, :16].contiguous(), w8[:, :16].contiguous(),
                        xs, ws, None)
    assert tq.dequant_gemm.launches == before


def _state_layout(model):
    return {k: (tuple(v.shape), v.dtype) for k, v in
            model.state_dict().items()}


def test_quant_knob_keeps_every_state_dict_key(monkeypatch):
    """Flipping quant: int8 changes no parameter name, shape or dtype (the
    JAX package checks its param pytree the same way), whether the knob
    comes from the config or from MMF_TPU_QUANT."""
    from mmf_tpu_torch.modules.transformer import Dense
    from mmf_tpu_torch.utils.flagship import mmbt_grid, visual_bert

    small = {"num_hidden_layers": 1, "hidden_size": 32,
             "num_attention_heads": 4, "intermediate_size": 64}
    builders = {
        "visual_bert": lambda q: visual_bert(
            dict(small, visual_embedding_dim=8, quant=q)),
        "mmbt": lambda q: mmbt_grid({
            "direct_features_input": True, "modal_hidden_size": 8,
            "quant": q, "text_encoder": {"params": dict(small)}}),
    }
    for name, build in builders.items():
        plain = _state_layout(build("none"))
        assert _state_layout(build("int8")) == plain, name
        monkeypatch.setenv("MMF_TPU_QUANT", "int8")
        model = build("none")
        monkeypatch.delenv("MMF_TPU_QUANT")
        assert _state_layout(model) == plain, name
        n_quant = sum(isinstance(m, tq.QuantDense) for m in model.modules())
        # every trunk projection (6 per layer) and the pooler; VisualBERT
        # also quantises its visual projection and head transform
        assert n_quant == {"visual_bert": 9, "mmbt": 7}[name]
        # the classifier stays a plain Dense, as in JAX
        assert type(model.classifier_logits if name == "visual_bert"
                    else model.classifier) is Dense


@pytest.mark.parametrize("m,n,tile", [
    # 128 x 128 tiles once they alone give each of the 132 SMs a block
    (7296, 3072, 128), (7296, 768, 128), (3200, 768, 128), (1408, 1536, 128),
    # else 64 x 64 tiles: MMBT's trunk and pooler, VisualBERT's pooler
    (131, 3072, 64), (131, 768, 64), (1, 768, 64), (32, 768, 64),
    (1408, 1408, 64), (64, 70, 64), (1, 9, 64),
])
def test_k5_tile_follows_the_output_shape(m, n, tile):
    assert tq.k5_tile(m, n) == tile


def test_k5_tile_follows_the_sm_count():
    assert tq.k5_tile(1024, 1024, sms=64) == 128
    assert tq.k5_tile(1024, 1024, sms=65) == 64
    assert tq.k5_tile(131, 3072, sms=48) == 128
    assert tq.k5_tile(131, 3072, sms=49) == 64


@pytest.mark.parametrize("k", [1, 15, 16, 40, 768, 776])
def test_pad_k_keeps_the_int32_sums(k):
    """``pad_k`` gives whole 16-byte vectors along K with zero columns,
    and the plain version on the padded operands gives the same bits."""
    g = torch.Generator().manual_seed(k)
    x8 = torch.randint(-127, 128, (5, k), generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (7, k), generator=g, dtype=torch.int8)
    xs, ws, b = torch.rand(5, generator=g), torch.rand(7, generator=g), \
        torch.randn(7, generator=g)
    px, pw = tq.pad_k(x8, w8)
    assert px.shape == (5, -(-k // 16) * 16) and pw.shape[1] == px.shape[1]
    assert not px[:, k:].any() and not pw[:, k:].any()
    assert torch.equal(px[:, :k], x8) and torch.equal(pw[:, :k], w8)
    for out_dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            tq.dequant_gemm_reference(px, pw, xs, ws, b, out_dtype),
            tq.dequant_gemm_reference(x8, w8, xs, ws, b, out_dtype))


def test_int8_dense_at_a_ragged_k_matches_jax():
    """K = 40 (not whole 16-byte vectors; the card zero-pads it for K5)
    against JAX, whose XLA path takes any K."""
    rng = np.random.RandomState(6)
    x = rng.randn(7, 40).astype(np.float32)
    w = (rng.randn(40, 24) * 0.05).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b)))
    got = tq.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])
