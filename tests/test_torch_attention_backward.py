"""The port's attention for training against the JAX package: K1's stats
form (``flash_forward_reference``) against JAX's ``_flash_forward(...,
with_lse=True)``, and the backward (``flash_backward_reference``, and
autograd through the port's ``dot_product_attention``) against
``jax.grad`` through ``flash_attention``. The JAX side runs its Pallas
kernels (K1 stats form, K2, K3) in interpret mode; the port runs its plain
versions, which the CUDA kernels are held against on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py). The f32 kernels'
split-TF32 arithmetic (K1 in its stats and raw forms, K2 and K3) is
emulated here in plain torch at ViLT's shape and held against both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmf_tpu.ops import attention as jattn
from mmf_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)  # several test workers share the host

# gradients, as max abs error over the largest reference entry. f32: the
# same formulas in another summation order; bf16: inputs, outputs and the
# rounded probabilities in bf16 (one ulp is 2^-8 relative), both sides
# accumulating in f32
GRAD_REL = {"float32": 2e-5, "bfloat16": 2e-2}
OUT_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _case(name):
    """(q, k, v, mask-or-bias, dout) numpy inputs of one named case."""
    shapes = {  # name: ((B, H, Sq, Skv, D), seed)
        "padding_mask": ((2, 3, 12, 12, 16), 1),
        "sq_ne_skv": ((2, 2, 9, 21, 8), 2),
        "user_masked_row": ((2, 2, 6, 6, 8), 3),
        "d16_ragged_37": ((1, 2, 37, 37, 16), 0),
        # the bf16 kernels' tile edges: past two 64-row tiles, and a 64-row
        # q tile against a ragged kv ring
        "edge_130": ((1, 2, 130, 130, 64), 4),
        "q64_kv200_d32": ((1, 2, 64, 200, 32), 5)}
    (b, h, sq, skv, d), seed = shapes[name]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, skv, d).astype(np.float32)
    v = rng.randn(b, h, skv, d).astype(np.float32)
    dout = rng.randn(b, h, sq, d).astype(np.float32)
    if name == "user_masked_row":
        # one q row masked at every column with the finite mask value and
        # one batch whose every column is masked
        bias = np.zeros((b, 1, sq, skv), np.float32)
        bias[0, 0, 3, :] = jattn.DEFAULT_MASK_VALUE
        bias[1] = jattn.DEFAULT_MASK_VALUE
        return q, k, v, bias, dout
    mask = (rng.rand(b, skv) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return q, k, v, mask, dout


CASES = ["padding_mask", "sq_ne_skv", "user_masked_row", "d16_ragged_37",
         "edge_130", "q64_kv200_d32"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_both(q, k, v, bias_np, dout, dtype):
    jdt, tdt = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in (q, k, v, dout)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v, dout)]
    if bias_np.ndim == 2:  # padding mask -> make_attention_bias
        jb = jattn.make_attention_bias(jnp.asarray(bias_np), jdt)
        tb = tattn.make_attention_bias(torch.from_numpy(bias_np), tdt)
    else:
        jb, tb = jnp.asarray(bias_np), torch.from_numpy(bias_np)
    return jx, jb, tx, tb


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_stats_form_matches_jax_with_lse(case, dtype, monkeypatch):
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    q, k, v, bias_np, dout = _case(case)
    (jq, jk, jv, _), jb, (tq, tk, tv, _), tb = _to_both(q, k, v, bias_np,
                                                        dout, dtype)
    scale = q.shape[-1] ** -0.5
    j_out, j_m, j_l = jattn._flash_forward(jq, jk, jv, jb, scale, 512, 1024,
                                           True, with_lse=True)
    sq = q.shape[2]
    out, m, l = tattn.flash_forward_reference(tq, tk, tv, tb)
    assert m.dtype == l.dtype == torch.float32 and m.shape == q.shape[:3]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out[:, :, :sq], np.float32),
                               atol=OUT_ATOL[dtype], rtol=0)
    # JAX stores the stats lane-replicated over 128 lanes
    np.testing.assert_allclose(m.numpy(), np.asarray(j_m[:, :, :sq, 0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(j_l[:, :, :sq, 0]),
                               rtol=1e-5, atol=1e-5)


def _jax_grads(jq, jk, jv, jb, jdout):
    def f(q_, k_, v_):
        out = jattn.flash_attention(q_, k_, v_, jb, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jdout.astype(jnp.float32))

    return jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_backward_matches_jax_kernels(case, dtype, monkeypatch):
    """flash_backward_reference from the stats form, and autograd through
    dot_product_attention, against jax.grad through JAX's K2 and K3."""
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    q, k, v, bias_np, dout = _case(case)
    (jq, jk, jv, jdout), jb, (tq, tk, tv, tdout), tb = _to_both(
        q, k, v, bias_np, dout, dtype)
    want = _jax_grads(jq, jk, jv, jb, jdout)

    out, m, l = tattn.flash_forward_reference(tq, tk, tv, tb)
    plain = tattn.flash_backward_reference(tq, tk, tv, tb, out, m, l, tdout)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tattn.dot_product_attention(*leaves, tb).backward(tdout)
    for name, p, leaf, w in zip("qkv", plain, leaves, want):
        assert p.dtype == leaf.grad.dtype == DTYPES[dtype][1]
        assert p.shape == leaf.grad.shape == tuple(w.shape)
        for what, got in (("plain", p), ("autograd", leaf.grad)):
            err = _rel_err(got.float().numpy(), w)
            assert err < GRAD_REL[dtype], f"d{name} ({what}): rel {err:.2e}"


def test_backward_of_minus_inf_rows_is_zero_not_nan(monkeypatch):
    """Two combined masks overflow to -inf: a row that is -inf at every
    column gets zero gradients from the port (stats m = 0, l = 1), where
    JAX gives NaN; every other row matches JAX."""
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    rng = np.random.RandomState(11)
    q, k, v, dout = (rng.randn(2, 2, 5, 8).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((2, 5), np.int32)
    mask[1] = 0
    jm = jattn.make_attention_bias(jnp.asarray(mask))
    tm = tattn.make_attention_bias(torch.from_numpy(mask))
    jb, tb = jattn.combine_biases(jm, jm), tattn.combine_biases(tm, tm)
    tq, tk, tv, tdout = map(torch.from_numpy, (q, k, v, dout))
    out, m, l = tattn.flash_forward_reference(tq, tk, tv, tb)
    assert (m[1] == 0).all() and (l[1] == 1).all()
    grads = tattn.flash_backward_reference(tq, tk, tv, tb, out, m, l, tdout)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tattn.dot_product_attention(*leaves, tb).backward(tdout)
    want = _jax_grads(*map(jnp.asarray, (q, k, v)), jb, jnp.asarray(dout))
    for g, leaf, w in zip(grads, leaves, want):
        for got in (g, leaf.grad):
            assert (got[1] == 0).all()
            np.testing.assert_allclose(got[0].numpy(), np.asarray(w[0]),
                                       atol=1e-5, rtol=0)
        assert np.isnan(np.asarray(w[1])).any()  # the JAX divergence


def test_autograd_function_needs_the_card():
    """On CPU tensors the kernel wrappers refuse instead of running the
    plain version, and dot_product_attention takes the plain version only
    because the tensors lie on the CPU."""
    q = torch.zeros(1, 2, 8, 8, requires_grad=True)
    stats = torch.zeros(1, 2, 8)
    counts = [f.launches for f in (tattn.flash_attention_with_stats,
                                   tattn.flash_attention_bwd_dq,
                                   tattn.flash_attention_bwd_dkv)]
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tattn.flash_attention_with_stats(q, q, q)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tattn.flash_attention_bwd_dq(q, q, q, None, q, stats, stats, q)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tattn.flash_attention_bwd_dkv(q, q, q, None, q, stats, stats, stats)
    tattn.dot_product_attention(q, q, q).sum().backward()
    assert q.grad is not None
    assert [f.launches for f in (tattn.flash_attention_with_stats,
                                 tattn.flash_attention_bwd_dq,
                                 tattn.flash_attention_bwd_dkv)] == counts


# --- the f32 K2/K3 arithmetic: split-TF32 products ------------------------
# The kernels split each f32 operand x as hi = x with its low 13 mantissa
# bits cleared and lo = x - hi, which the tensor core reads truncated to
# TF32 in turn, and run each product as lo hi + hi lo + hi hi (lo lo
# dropped). Held here 10x inside the card's f32 gradient bound (GRAD_REL
# 1e-4 in tests/test_torch_cuda_kernels.py and chip_smoke.py).
CARD_GRAD_REL_F32 = 1e-4
VILT_SEQ, VILT_S = 40, 617  # text tokens; text + [CLS] + 576 patches


def _tf32(x, mode):
    """x as TF32: "truncate" clears the low 13 mantissa bits (what the
    kernels do, and how the tensor core reads an f32), "round" rounds to
    nearest, ties away (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    if mode == "round":
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _split_mm(a, b, mode):
    """a @ b as three TF32 products, the small terms first."""
    a_hi, b_hi = _tf32(a, mode), _tf32(b, mode)
    a_lo, b_lo = _tf32(a - a_hi, mode), _tf32(b - b_hi, mode)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _split_tf32_backward(q, k, v, bias, out, m, l, dout, scale, mode):
    """K2's and K3's formulas with every product in split-TF32: p from the
    forward's m and l, delta = rowsum(dO O), ds = p (dO v^T - delta)."""
    kt = k.transpose(-1, -2)
    p = torch.exp(_split_mm(q, kt, mode) * scale + bias - m[..., None])
    p = p / l[..., None]
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (_split_mm(dout, v.transpose(-1, -2), mode) - delta)
    return (_split_mm(ds, k, mode) * scale,
            _split_mm(ds.transpose(-1, -2), q, mode) * scale,
            _split_mm(p.transpose(-1, -2), dout, mode))


@pytest.fixture(scope="module")
def vilt_f32_case():
    """Two heads of two ViLT samples (questions of 9 and 40 tokens, every
    patch valid), f32: the inputs, the port's plain backward and JAX's
    backward through its K2 and K3 (interpret mode)."""
    rng = np.random.RandomState(12)
    q, k, v, dout = (rng.randn(2, 2, VILT_S, 64).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((2, VILT_S), np.int32)
    mask[:, :VILT_SEQ] = np.arange(VILT_SEQ)[None] < np.array([[9], [40]])
    (jq, jk, jv, jdout), jb, (tq, tk, tv, tdout), tb = _to_both(
        q, k, v, mask, dout, "float32")
    out, m, l = tattn.flash_forward_reference(tq, tk, tv, tb)
    plain = tattn.flash_backward_reference(tq, tk, tv, tb, out, m, l, tdout)
    jax_grads = [np.asarray(g) for g in _jax_grads(jq, jk, jv, jb, jdout)]
    return (tq, tk, tv, tb, out, m, l, tdout), plain, jax_grads


@pytest.mark.parametrize("mode", ["truncate", "round"])
def test_split_tf32_backward_is_inside_the_f32_bound(vilt_f32_case, mode,
                                                     monkeypatch):
    """At ViLT's 617 x 617 per head (D = 64, its length mask) the split-
    TF32 dq, dk, dv stay 10x inside the card's f32 bound of both the plain
    backward and JAX's; one TF32 product alone does not. The recomputed
    scores may put p a hair above 1 (m and l come from the forward's
    products): that stays inside too."""
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    args, plain, jax_grads = vilt_f32_case
    scale = 64 ** -0.5
    got = _split_tf32_backward(*args, scale, mode)
    for name, g, p, j in zip("qkv", got, plain, jax_grads):
        for what, want in (("plain", p.numpy()), ("jax", j)):
            err = _rel_err(g.numpy(), want)
            assert err < CARD_GRAD_REL_F32 / 10, (
                f"d{name} vs {what} ({mode}): rel {err:.2e}")
    # plain TF32 (hi hi alone) misses the bound: the split is what holds
    q, k = args[0], args[1]
    tf32_scores = _tf32(q, mode) @ _tf32(k, mode).transpose(-1, -2)
    f32_scores = q @ k.transpose(-1, -2)
    assert _rel_err(tf32_scores.numpy(), f32_scores.numpy()) > \
        CARD_GRAD_REL_F32


# --- the f32 K1 arithmetic: split-TF32 products --------------------------
# The forward's bounds on the card (tests/test_torch_cuda_kernels.py,
# chip_smoke.py): the output within TOL, m and l within STATS_TOL, the
# raw form's accumulator within RAW_REL of its largest entry.
CARD_TOL_F32 = dict(atol=1e-5, rtol=1e-5)
CARD_STATS_TOL = dict(atol=1e-4, rtol=1e-4)
CARD_RAW_REL_F32 = 1e-5
LOG2E = np.float32(1.4426950408889634)


def _split_tf32_forward(q, k, v, bias, scale, mode, products=_split_mm):
    """K1's arithmetic: s = q k^T as ``products`` (split-TF32), the scores
    fmaf(s, scale, bias), the online softmax over 64-column kv tiles with
    exp as exp2((s - m) log2 e), and o += p v as ``products`` with p in
    f32, into the accumulator already rescaled by exp(m_old - m_new).
    Returns the stats form (out, m, l; m = 0, l = 1 on a row with no
    finite score) and the raw form (acc, m, l)."""
    skv = k.shape[2]
    bias = bias.expand(*q.shape[:3], skv)
    m = torch.full(q.shape[:3], -torch.inf)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros_like(q)
    for kv0 in range(0, skv, 64):
        cols = slice(kv0, kv0 + 64)
        s = products(q, k[:, :, cols].transpose(-1, -2), mode) * scale
        s = s + bias[..., cols]
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp2((m - m_use) * LOG2E)
        p = torch.exp2((s - m_use[..., None]) * LOG2E)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + products(p, v[:, :, cols], mode)
        m = m_new
    empty = ~(l > 0)
    out = acc / torch.where(empty, 1.0, l)[..., None]
    return ((out, torch.where(empty, 0.0, m), torch.where(empty, 1.0, l)),
            (acc, m, l))


def _tf32_mm(a, b, mode):
    """a @ b as one TF32 product (hi hi alone)."""
    return _tf32(a, mode) @ _tf32(b, mode)


@pytest.fixture(scope="module")
def vilt_f32_forward(vilt_f32_case):
    """The port's plain K1 forms and JAX's K1 (interpret mode: the stats
    form through _flash_forward, the raw form through
    flash_attention_block) on the ViLT case's inputs, numpy."""
    (tq, tk, tv, tb, out, m, l, _), _, _ = vilt_f32_case
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (tq, tk, tv))
    jb = jnp.asarray(tb.numpy())
    sq, scale = tq.shape[2], 64 ** -0.5
    j_out, j_m, j_l = jattn._flash_forward(jq, jk, jv, jb, scale, 512, 1024,
                                           True, with_lse=True)
    j_raw = jattn.flash_attention_block(jq, jk, jv, jb, interpret=True)
    raw = tattn.flash_attention_block_reference(tq, tk, tv, tb)
    return {"plain": ([out, m, l], raw),
            "jax": ([np.asarray(j_out[:, :, :sq]),
                     np.asarray(j_m[:, :, :sq, 0]),
                     np.asarray(j_l[:, :, :sq, 0])], j_raw)}


def _inside_forward_bounds(got, want, what):
    """Asserts the stats form (out, m, l) and the raw form (acc, m, l)
    `got` inside the card's f32 forward bounds of `want`; returns the
    largest share of a bound used."""
    (out, m, l), (acc, rm, rl) = got
    (w_out, w_m, w_l), (w_acc, w_rm, w_rl) = (
        [np.asarray(x, np.float32) for x in form] for form in want)
    shares = []
    for name, g, w, tol in (("out", out, w_out, CARD_TOL_F32),
                            ("m", m, w_m, CARD_STATS_TOL),
                            ("l", l, w_l, CARD_STATS_TOL),
                            ("raw m", rm, w_rm, CARD_STATS_TOL),
                            ("raw l", rl, w_rl, CARD_STATS_TOL)):
        err = np.abs(g.numpy() - w)
        share = float((err / (tol["atol"] + tol["rtol"] * np.abs(w))).max())
        assert share <= 1.0, f"{name} vs {what}: {share:.2f} of the bound"
        shares.append(share)
    err = _rel_err(acc.numpy(), w_acc)
    assert err <= CARD_RAW_REL_F32, f"raw acc vs {what}: rel {err:.2e}"
    return max(shares + [err / CARD_RAW_REL_F32])


@pytest.mark.parametrize("mode", ["truncate", "round"])
def test_split_tf32_forward_is_inside_the_f32_bounds(vilt_f32_case,
                                                     vilt_f32_forward, mode):
    """K1's split-TF32 arithmetic at ViLT's 617 x 617 per head (D = 64, its
    length mask), in its stats and raw forms (the inference form's output
    is the stats form's), stays inside the card's unchanged f32 forward
    bounds (TOL, STATS_TOL, RAW_REL) of the plain version and of JAX's K1,
    with truncated or rounded splits: at most 0.12 of a bound (the raw
    accumulator's RAW_REL; the output uses 0.05 of TOL, m 0.01 and l 0.03
    of STATS_TOL), held here at a quarter. One TF32 product alone (hi hi)
    misses the output's bound 20-80 times over."""
    (tq, tk, tv, tb, *_), _, _ = vilt_f32_case
    scale = 64 ** -0.5
    got = _split_tf32_forward(tq, tk, tv, tb, scale, mode)
    for what, want in vilt_f32_forward.items():
        share = _inside_forward_bounds(got, want, what)
        assert share < 0.25, f"{what} ({mode}): {share:.2f} of a bound"
    (tf32_out, _, _), _ = _split_tf32_forward(tq, tk, tv, tb, scale, mode,
                                              products=_tf32_mm)
    plain_out = vilt_f32_forward["plain"][0][0]
    assert not torch.allclose(tf32_out, plain_out, **CARD_TOL_F32)
