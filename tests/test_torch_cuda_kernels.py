"""The port's hand-written kernels against their plain PyTorch versions,
on the card. Marked ``cuda``: they skip where there is no NVIDIA card
(a CUDA kernel has no CPU mode). Run them on a machine with one:
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``
(``--noconftest`` because ``tests/conftest.py`` imports JAX, which a GPU
machine serving the port need not have)."""

import pytest
import torch

from mmf_tpu_torch.ops import attention as A
from mmf_tpu_torch.ops import layernorm as L
from mmf_tpu_torch.ops import quant as Q

pytestmark = pytest.mark.cuda

# f32: same algorithm, different summation order; bf16: outputs rounded
# to bf16 (one ulp is 2^-8 relative)
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda")


# ViLBERT's attention calls at D = 128 (8 heads): image self-attention over
# 100 regions, text queries over the regions, region queries over the text
VILBERT_SHAPES = [(4, 8, 100, 100, 128), (4, 8, 128, 100, 128),
                  (4, 8, 100, 128, 128)]

# the bf16 blocks' edges: q rows that fill one 64-row block or not, or spill
# one row into the next (1, 63-65, 100, 127-129), against kv of one row, one
# whole ring tile, a ragged second tile and a ragged third (1, 64, 100, 130),
# at both head-dim widths of the blocks (one and two 64-column boxes). Two
# batches: the second's every column is masked
EDGE_SHAPES = [(2, 2, sq, skv, d) for d in (64, 128)
               for sq in (1, 63, 64, 65, 100, 127, 128, 129)
               for skv in (1, 64, 100, 130)]


# ViLT's: 40 text tokens and 577 image tokens (617 = 9 x 64 + 41), f32
VILT_SHAPE = (2, 12, 617, 617, 64)
# MMFT's on VQA2: 14 text tokens and 100 regions (114 = 64 + 50), bf16
MMFT_SHAPE = (2, 12, 114, 114, 64)
# Hateful Memes: MMBT's 3 modal tokens and 128 text tokens (131 = 2 x 64
# + 3), bf16; the baselines' f32 BERT over 128 tokens (two full tiles)
MMBT_SHAPE = (2, 12, 131, 131, 64)
BASELINE_SHAPE = (2, 12, 128, 128, 64)
HM_SHAPES = [MMBT_SHAPE, BASELINE_SHAPE]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 12, 228, 228, 64), (1, 2, 37, 37, 64),
                                   (2, 3, 9, 130, 16), (1, 2, 70, 70, 128)]
                         + VILBERT_SHAPES + [VILT_SHAPE, MMFT_SHAPE]
                         + HM_SHAPES + EDGE_SHAPES)
def test_flash_attention_matches_plain(card, dtype, shape):
    b, h, sq, skv, d = shape
    g = torch.Generator(device=card).manual_seed(0)
    # q as the [B,S,H,D] -> [B,H,S,D] view the attention block hands over
    q = torch.randn(b, sq, h, d, device=card, generator=g).to(dtype)
    q = q.transpose(1, 2)
    k = torch.randn(b, h, skv, d, device=card, generator=g).to(dtype)
    v = torch.randn(b, h, skv, d, device=card, generator=g).to(dtype)
    mask = (torch.rand(b, skv, device=card, generator=g) > 0.3).int()
    mask[:, 0] = 1
    mask[-1] = 0  # one batch with every column user-masked
    bias = A.make_attention_bias(mask, dtype)
    before = A.flash_attention.launches
    # the two masks summed overflow to -inf on the last batch
    for bb, empty in ((None, False), (bias, False),
                      (A.combine_biases(bias, bias), True)):
        out = A.flash_attention(q, k, v, bb)
        out_s, m, l = A.flash_attention_with_stats(q, k, v, bb)
        torch.cuda.synchronize()
        ref = A.mha_reference(q, k, v, bb)
        assert not torch.isnan(out).any()
        torch.testing.assert_close(out, ref, **TOL[dtype])
        if empty:  # rows whose every column is -inf: zeros
            assert (out[-1] == 0).all()
        # the stats form: the inference form's output, and m, l
        assert torch.equal(out_s, out)
        _, ref_m, ref_l = A.flash_forward_reference(q, k, v, bb)
        torch.testing.assert_close(m, ref_m, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(l, ref_l, atol=1e-4, rtol=1e-4)
    assert A.flash_attention.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_residual", [False, True])
def test_layer_norm_kernel_matches_plain(card, dtype, with_residual):
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(4, 57, 768, device=card, generator=g).to(dtype)
    res = torch.randn_like(x) if with_residual else None
    w = 1.0 + 0.1 * torch.randn(768, device=card, generator=g)
    bias = 0.1 * torch.randn(768, device=card, generator=g)
    before = L.layer_norm_kernel.launches
    out = L.layer_norm(x, w, bias, res)
    torch.cuda.synchronize()
    assert L.layer_norm_kernel.launches == before + 1
    torch.testing.assert_close(out, L._ln_reference(x, res, w, bias, 1e-12),
                               **TOL[dtype])


# backward kernels: gradients are compared relative to the largest
# reference entry. f32: the same formulas, other summation orders, the
# kernels' products in split-TF32 (inputs kept to ~21 bits; the plain
# version's TF32 off); bf16: p and ds are rounded to bf16 before the
# tensor-core products (one ulp is 2^-8 relative) and the gradients are
# stored in bf16
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_rel(got, want, rel, what):
    want = want.float()
    err = float((got.float() - want).abs().max())
    scale = max(float(want.abs().max()), 1e-6)
    assert not torch.isnan(got).any(), f"{what}: NaN"
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} * {scale}"


def _bwd_case(card, dtype, b, h, sq, skv, d, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)

    def proj(s):  # the [B,S,H,D] -> [B,H,S,D] view of a projection
        return torch.randn(b, s, h, d, device=card, generator=g).to(
            dtype).transpose(1, 2)

    q, k, v = proj(sq), proj(skv), proj(skv)
    mask = (torch.rand(b, skv, device=card, generator=g) > 0.3).int()
    mask[:, 0] = 1
    if b > 1:  # one batch whose every column is -inf (two masks combined)
        mask[-1] = 0
        last = torch.ones_like(mask)
        last[-1] = 0
        bias = A.combine_biases(A.make_attention_bias(mask, dtype),
                                A.make_attention_bias(last, dtype))
    else:
        bias = A.make_attention_bias(mask, dtype)
    dout = torch.randn(b, sq, h, d, device=card, generator=g).to(
        dtype).transpose(1, 2)
    return q, k, v, bias, dout


# the main path's shape, ragged shapes, and the bf16 kernels' tile edges
# (128-row blocks, 64-row ring tiles)
BWD_SHAPES = [(2, 12, 228, 228, 64), (2, 3, 128, 100, 64),
              (1, 2, 37, 70, 8), (2, 2, 9, 130, 16), (1, 2, 70, 45, 24),
              (1, 2, 70, 70, 128), (1, 2, 127, 127, 64),
              (1, 2, 129, 129, 64), (1, 2, 256, 256, 64),
              (1, 2, 257, 257, 64), (1, 2, 64, 300, 64)] + VILBERT_SHAPES + [
                  VILT_SHAPE, MMFT_SHAPE] + HM_SHAPES + [
                  # one kv column: p = 1 and ds = dp - delta cancels, so dq
                  # is zero but for rounding and no relative bound holds it
                  s for s in EDGE_SHAPES if s[3] > 1]


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_stats_and_backward_match_plain(card, no_tf32, dtype, shape):
    b, h, sq, skv, d = shape
    q, k, v, bias, dout = _bwd_case(card, dtype, *shape)
    counts = (A.flash_attention_with_stats.launches,
              A.flash_attention_bwd_dq.launches,
              A.flash_attention_bwd_dkv.launches)
    out, m, l = A.flash_attention_with_stats(q, k, v, bias)
    dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
    torch.cuda.synchronize()
    assert (A.flash_attention_with_stats.launches,
            A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)

    ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
    torch.testing.assert_close(out, ref_out, **TOL[dtype])
    # the stats form computes what the inference form does
    assert torch.equal(out, A.flash_attention(q, k, v, bias))
    torch.testing.assert_close(m, ref_m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, ref_l, atol=1e-4, rtol=1e-4)
    want_delta = (dout.float() * out.float()).sum(-1)
    torch.testing.assert_close(delta, want_delta, atol=1e-3, rtol=1e-4)

    want = A.flash_backward_reference(q, k, v, bias, out, m, l, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        _assert_rel(got, ref, GRAD_REL[dtype], name)
    if b > 1:  # the -inf batch: zero outputs and gradients, not NaN
        assert (out[-1] == 0).all()
        assert (dq[-1] == 0).all() and (dk[-1] == 0).all()
        assert (dv[-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 100, 150, 64), (1, 2, 70, 45, 128)])
def test_backward_with_a_per_row_bias(card, no_tf32, dtype, shape):
    """A [B,1,Sq,Skv] bias (no stride 0 over q), with -inf entries: the
    kernels read it per element."""
    b, h, sq, skv, d = shape
    q, k, v, _, dout = _bwd_case(card, dtype, *shape, seed=5)
    g = torch.Generator(device=card).manual_seed(6)
    bias = torch.randn(b, 1, sq, skv, device=card, generator=g)
    bias[:, :, :, 1::7] = float("-inf")
    out, m, l = A.flash_attention_with_stats(q, k, v, bias)
    dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
    torch.cuda.synchronize()
    want = A.flash_backward_reference(q, k, v, bias, out, m, l, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_rel(got, ref, GRAD_REL[dtype], name)


def _m4c_case(card, case, b=2, seed=11):
    """M4C's attention calls, f32, 12 heads of 64, with its -10000 biases:
    TextBert over 20 question tokens (padding by length); the training
    pass over 182 = 20 + 100 + 50 + 12 tokens with the per-row prefix-LM
    bias [B,1,182,182] (padding in the question, objects and OCR tokens,
    the last 12 causal); the prefill over the 170 prefix tokens; the
    decode's 12 queries over 170 cached + 12 own keys, bias [B,1,12,182].
    (q, k, v, bias, dO)."""
    g = torch.Generator(device=card).manual_seed(seed)
    spans = (20, 100, 50)
    valid = [torch.arange(n, device=card)[None] < torch.randint(
        1 if n == 20 else 0, n + 1, (b, 1), device=card, generator=g)
        for n in spans]
    mask = torch.cat(valid + [torch.ones(b, 12, dtype=torch.bool,
                                         device=card)], 1).float()
    if case == "textbert":
        sq = skv = 20
        bias = ((1.0 - mask[:, :20]) * -10000.0)[:, None, None, :]
    elif case == "prefill":
        sq = skv = 170
        bias = ((1.0 - mask[:, :170]) * -10000.0)[:, None, None, :]
    else:
        ext = mask[:, None, None, :].expand(b, 1, 182, 182).clone()
        ext[:, :, -12:, -12:] = torch.tril(torch.ones(12, 12, device=card))
        bias = (1.0 - ext) * -10000.0
        sq, skv = (12, 182) if case == "decode" else (182, 182)
        if case == "decode":
            bias = bias[:, :, -12:].contiguous()

    def proj(s):
        return torch.randn(b, s, 12, 64, device=card,
                           generator=g).transpose(1, 2)

    return proj(sq), proj(skv), proj(skv), bias, proj(sq)


@pytest.mark.parametrize("case", ["textbert", "train", "prefill", "decode"])
def test_m4c_shapes_match_plain(card, no_tf32, case):
    """K1 in its three forms, K2 and K3 at M4C's shapes against their
    plain versions (the f32 bounds above)."""
    q, k, v, bias, dout = _m4c_case(card, case)
    out = A.flash_attention(q, k, v, bias)
    out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
    acc, m_raw, l_raw = A.flash_attention_block(q, k, v, bias)
    dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
    torch.cuda.synchronize()
    ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
    torch.testing.assert_close(out, ref_out, **TOL[torch.float32])
    assert torch.equal(out, out_s)
    torch.testing.assert_close(m, ref_m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, ref_l, atol=1e-4, rtol=1e-4)
    raw = A.flash_attention_block_reference(q, k, v, bias)
    _assert_rel(acc, raw[0], 1e-5, "acc")
    torch.testing.assert_close(m_raw, raw[1], atol=1e-4, rtol=1e-5)
    want = A.flash_backward_reference(q, k, v, bias, out_s, m, l, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_rel(got, ref, GRAD_REL[torch.float32], name)


# UNITER's, VinVL's and LXMERT's f32 attention (12 heads of 64): UNITER's
# 128 + 100 = 228 tokens, VinVL's 70 + 100 = 170; LXMERT's self-attention
# over 128 text tokens and 100 regions and its cross-attention both ways
# (128 x 100, 100 x 128), and the same at its pretraining's 20 tokens and
# 36 regions (one ragged tile each way)
VL3_SHAPES = [(2, 12, 228, 228, 64), (2, 12, 170, 170, 64),
              (2, 12, 100, 100, 64), (2, 12, 128, 100, 64),
              (2, 12, 100, 128, 64), (2, 12, 20, 20, 64),
              (2, 12, 36, 36, 64), (2, 12, 20, 36, 64), (2, 12, 36, 20, 64)]


@pytest.mark.parametrize("shape", VL3_SHAPES)
def test_vl3_shapes_match_plain(card, no_tf32, shape):
    """K1 in its three forms, K2 and K3 in f32 at UNITER's, VinVL's and
    LXMERT's shapes, with their keys' padding bias (-10000 past a ragged
    length, at least half the keys kept), against their plain versions
    (the f32 bounds above)."""
    b, h, sq, skv, d = shape
    g = torch.Generator(device=card).manual_seed(sq * 1000 + skv)
    keep = torch.arange(skv, device=card)[None] < torch.randint(
        skv // 2, skv + 1, (b, 1), device=card, generator=g)
    bias = ((1.0 - keep.float()) * -10000.0)[:, None, None, :]

    def proj(n):
        return torch.randn(b, n, h, d, device=card,
                           generator=g).transpose(1, 2)

    q, k, v, dout = proj(sq), proj(skv), proj(skv), proj(sq)
    out = A.flash_attention(q, k, v, bias)
    out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
    acc, m_raw, _ = A.flash_attention_block(q, k, v, bias)
    dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
    torch.cuda.synchronize()
    ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
    torch.testing.assert_close(out, ref_out, **TOL[torch.float32])
    assert torch.equal(out, out_s)
    torch.testing.assert_close(m, ref_m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, ref_l, atol=1e-4, rtol=1e-4)
    raw = A.flash_attention_block_reference(q, k, v, bias)
    _assert_rel(acc, raw[0], 1e-5, "acc")
    torch.testing.assert_close(m_raw, raw[1], atol=1e-4, rtol=1e-5)
    want = A.flash_backward_reference(q, k, v, bias, out_s, m, l, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_rel(got, ref, GRAD_REL[torch.float32], name)


def test_m4c_cached_decode_equals_the_full_pass_rows(card, no_tf32):
    """K1 over the decode's 12 queries with the prefix's K/V prepended
    (M4C's cached greedy decode) against K1 over the whole 182-token
    sequence's last 12 rows: the same scores, bias and keys a row."""
    q, k, v, bias, _ = _m4c_case(card, "train", seed=12)
    full = A.flash_attention(q, k, v, bias)[:, :, -12:]
    cached = A.flash_attention(q[:, :, -12:].contiguous(), k, v,
                               bias[:, :, -12:].contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(cached, full, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 12, 228, 228, 64),
                                   (2, 8, 100, 128, 128)])
def test_backward_is_bit_equal_across_calls(card, dtype, shape):
    """No atomics: two calls on the same inputs give the same bits (the
    main path's D = 64 and ViLBERT's region queries at D = 128)."""
    q, k, v, bias, dout = _bwd_case(card, dtype, *shape, seed=7)
    out, m, l = A.flash_attention_with_stats(q, k, v, bias)
    first = A.flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout)
    first += A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, first[1])
    second = A.flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout)
    second += A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, second[1])
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def test_f32_backward_is_bit_equal_at_vilt_shape(card):
    """The split-TF32 K2 and K3 at ViLT's 617 rows: no atomics, so two
    calls give the same bits."""
    q, k, v, bias, dout = _bwd_case(card, torch.float32, *VILT_SHAPE,
                                    seed=9)
    out, m, l = A.flash_attention_with_stats(q, k, v, bias)
    runs = []
    for _ in range(2):
        dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout)
        runs.append((dq, delta) + A.flash_attention_bwd_dkv(
            q, k, v, bias, dout, m, l, delta))
    torch.cuda.synchronize()
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def test_f32_forward_is_bit_equal_at_vilt_shape(card):
    """The split-TF32 K1 at ViLT's 617 rows in its three forms (inference,
    stats, raw): no atomics, so two calls give the same bits."""
    q, k, v, bias, _ = _bwd_case(card, torch.float32, *VILT_SHAPE, seed=11)
    runs = [(A.flash_attention(q, k, v, bias),)
            + A.flash_attention_with_stats(q, k, v, bias)
            + A.flash_attention_block(q, k, v, bias) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("offset", ["pointer", "stride"])
def test_f32_forward_takes_views_tma_cannot_load(card, no_tf32, offset):
    """f32 views whose pointer ("pointer": 4 bytes past 16-byte alignment)
    or seq stride ("stride": 65 floats) TMA cannot take: the forward's
    wrappers copy them, and K1 in its three forms matches the plain
    versions."""
    b, h, sq, skv, d = 2, 3, 70, 45, 64
    g = torch.Generator(device=card).manual_seed(12)

    def view(s):  # [B,S,H,D] storage -> [B,H,S,D] view
        if offset == "pointer":
            x = torch.randn(b * s * h * d + 1, device=card, generator=g)
            x = x[1:].view(b, s, h, d)
        else:
            x = torch.randn(b, s, h, d + 1, device=card, generator=g)
            x = x[..., :d]
        return x.transpose(1, 2)

    q, k, v = view(sq), view(skv), view(skv)
    assert not A._kernel_layout_ok(q, tma=True)
    mask = (torch.rand(b, skv, device=card, generator=g) > 0.3).int()
    mask[:, 0] = 1
    bias = A.make_attention_bias(mask)
    counts = (A.flash_attention.launches,
              A.flash_attention_with_stats.launches,
              A.flash_attention_block.launches)
    out = A.flash_attention(q, k, v, bias)
    out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
    acc, raw_m, raw_l = A.flash_attention_block(q, k, v, bias)
    torch.cuda.synchronize()
    assert (A.flash_attention.launches,
            A.flash_attention_with_stats.launches,
            A.flash_attention_block.launches) == tuple(c + 1 for c in counts)
    ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
    for got in (out, out_s):
        torch.testing.assert_close(got, ref_out, **TOL[torch.float32])
    torch.testing.assert_close(m, ref_m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, ref_l, atol=1e-4, rtol=1e-4)
    ref = A.flash_attention_block_reference(q, k, v, bias)
    torch.testing.assert_close(raw_m, ref[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(raw_l, ref[2], atol=1e-4, rtol=1e-4)
    _assert_rel(acc, ref[0], 1e-5, "acc")


@pytest.mark.parametrize("offset", ["pointer", "stride"])
def test_f32_backward_takes_views_tma_cannot_load(card, no_tf32, offset):
    """f32 views whose pointer ("pointer": 4 bytes past 16-byte alignment)
    or seq stride ("stride": 65 floats) TMA cannot take: the wrappers copy
    them, and the kernels match the plain version."""
    b, h, sq, skv, d = 2, 3, 70, 45, 64
    g = torch.Generator(device=card).manual_seed(10)

    def view(s):  # [B,S,H,D] storage -> [B,H,S,D] view
        if offset == "pointer":
            x = torch.randn(b * s * h * d + 1, device=card, generator=g)
            x = x[1:].view(b, s, h, d)
        else:
            x = torch.randn(b, s, h, d + 1, device=card, generator=g)
            x = x[..., :d]
        return x.transpose(1, 2)

    q, k, v, dout = view(sq), view(skv), view(skv), view(sq)
    assert not A._kernel_layout_ok(q, tma=True)
    mask = (torch.rand(b, skv, device=card, generator=g) > 0.3).int()
    mask[:, 0] = 1
    bias = A.make_attention_bias(mask)
    out, m, l = A.flash_attention_with_stats(q, k, v, bias)
    counts = (A.flash_attention_bwd_dq.launches,
              A.flash_attention_bwd_dkv.launches)
    dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
    torch.cuda.synchronize()
    assert (A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches) == (counts[0] + 1,
                                                    counts[1] + 1)
    want = A.flash_backward_reference(q, k, v, bias, out, m, l, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_rel(got, ref, GRAD_REL[torch.float32], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES[:4] + [
    s for s in EDGE_SHAPES if s[3] > 1])  # two halves of at least a row
def test_raw_stats_form_matches_plain_and_merges(card, no_tf32, dtype, shape):
    """K1's raw-stats form against its plain version; the merged states of
    two kv blocks against K1 over the whole kv; an all -inf row gives
    (m = -inf, l = 0, acc = 0)."""
    b, h, sq, skv, d = shape
    q, k, v, bias, _ = _bwd_case(card, dtype, *shape, seed=8)
    before = A.flash_attention_block.launches
    acc, m, l = A.flash_attention_block(q, k, v, bias)
    torch.cuda.synchronize()
    assert A.flash_attention_block.launches == before + 1
    ref = A.flash_attention_block_reference(q, k, v, bias)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    torch.testing.assert_close(m, ref[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, ref[2], atol=1e-4, rtol=1e-4)
    _assert_rel(acc, ref[0], 1e-5 if dtype == torch.float32 else 1e-2, "acc")
    half = skv // 2
    states = [A.flash_attention_block(q, k[:, :, sl], v[:, :, sl],
                                      bias[..., sl])
              for sl in (slice(0, half), slice(half, skv))]
    macc, _, ml = A.merge_block_states(states)
    merged = macc / torch.where(ml == 0, torch.ones_like(ml), ml)[..., None]
    torch.testing.assert_close(merged.to(dtype), A.flash_attention(q, k, v,
                                                                   bias),
                               **TOL[dtype])
    if b > 1:  # the batch whose every column is -inf
        assert torch.isneginf(m[-1]).all() and (l[-1] == 0).all()
        assert (acc[-1] == 0).all()


@pytest.mark.parametrize("bucket", [1, 8, 32])
def test_m4c_served_decode_matches_plain(card, no_tf32, bucket):
    """K1's inference form at a served M4C decode step: the buckets'
    [b, 12, 12 rows, 182 keys] with the [b, 1, 12, 182] bias."""
    q, k, v, bias, _ = _m4c_case(card, "decode", b=bucket, seed=13)
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    torch.testing.assert_close(out, A.mha_reference(q, k, v, bias),
                               **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_zero_keys_give_zeros_without_a_launch(card, dtype, d):
    """Attention over zero keys (ROADMAP C.9): every form returns what the
    plain versions give (zeros; the stats form's m = 0, l = 1; the raw
    form's empty state m = -inf, l = 0), the backward dq = 0 and empty
    dk, dv, and no kernel is launched."""
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(2, 3, 70, d, device=card, generator=g).to(dtype)
    k = torch.empty(2, 3, 0, d, device=card, dtype=dtype)
    bias = torch.zeros(2, 1, 1, 0, device=card)
    kernels = (A.flash_attention, A.flash_attention_with_stats,
               A.flash_attention_block, A.flash_attention_bwd_dq,
               A.flash_attention_bwd_dkv)
    counts = [f.launches for f in kernels]
    out = A.flash_attention(q, k, k, bias)
    out_s, m, l = A.flash_attention_with_stats(q, k, k)
    acc, m_raw, l_raw = A.flash_attention_block(q, k, k, bias)
    dout = torch.randn(q.shape, device=card, generator=g).to(dtype)
    dq, delta = A.flash_attention_bwd_dq(q, k, k, bias, out_s, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, k, bias, dout, m, l, delta)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, k)]
    auto = A.dot_product_attention(*leaves, bias)
    auto.backward(dout)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == counts
    ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, k, bias)
    for got in (out, out_s, auto):
        assert got.shape == q.shape and got.dtype == dtype
        assert torch.equal(got, ref_out) and not got.any()
    assert torch.equal(m, ref_m) and torch.equal(l, ref_l)
    assert (m == 0).all() and (l == 1).all()
    ref_acc, ref_m_raw, ref_l_raw = A.flash_attention_block_reference(
        q, k, k, bias)
    assert torch.equal(acc, ref_acc) and not acc.any()
    assert torch.equal(m_raw, ref_m_raw) and torch.isneginf(m_raw).all()
    assert torch.equal(l_raw, ref_l_raw) and not l_raw.any()
    for grad in (dq, leaves[0].grad):
        assert grad.shape == q.shape and not grad.any()
    for grad in (dk, dv, leaves[1].grad, leaves[2].grad):
        assert grad.shape == (2, 3, 0, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_runs_the_kernels(card, no_tf32, dtype):
    """dot_product_attention with grad: stats form forward, K2 and K3 as
    its backward; gradients against autograd through mha_reference."""
    q, k, v, bias, dout = _bwd_case(card, dtype, 2, 4, 100, 100, 64, seed=3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    counts = (A.flash_attention.launches,
              A.flash_attention_with_stats.launches,
              A.flash_attention_bwd_dq.launches,
              A.flash_attention_bwd_dkv.launches)
    out = A.dot_product_attention(*leaves, bias)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (A.flash_attention.launches,
            A.flash_attention_with_stats.launches,
            A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches) == (
        counts[0], counts[1] + 1, counts[2] + 1, counts[3] + 1)
    ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = A.mha_reference(*ref_leaves, bias)
    ref.backward(dout.float())
    for name, got, want in zip("qkv", leaves, ref_leaves):
        _assert_rel(got.grad, want.grad, 1.5 * GRAD_REL[dtype], "d" + name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_residual", [False, True])
def test_layer_norm_autograd_matches_plain(card, dtype, with_residual):
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(4, 57, 768, device=card, generator=g).to(dtype)
    res = torch.randn_like(x) if with_residual else None
    w = 1.0 + 0.1 * torch.randn(768, device=card, generator=g)
    bias = 0.1 * torch.randn(768, device=card, generator=g)
    dy = torch.randn_like(x)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, res, w, bias) if t is not None]
        xi, *rest = leaves
        ri = rest.pop(0) if with_residual else None
        fn(xi, rest[0], rest[1], ri).backward(dy)
        return [t.grad for t in leaves]

    before = (L.layer_norm_kernel.launches,
              L.layer_norm_backward_kernel.launches)
    got = grads(lambda x_, w_, b_, r_: L.layer_norm(x_, w_, b_, r_))
    torch.cuda.synchronize()
    # one forward (K4) and one backward (K4-bwd) launch
    assert (L.layer_norm_kernel.launches,
            L.layer_norm_backward_kernel.launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = grads(lambda x_, w_, b_, r_: L._ln_reference(x_, r_, w_, b_,
                                                         1e-12))
    # autograd through the plain forward: other formulas, other summation
    # orders; dx (and dresidual) round to x's dtype, dscale and dbias are
    # f32 in both dtypes
    names = ["dx"] + (["dresidual"] if with_residual else []) + [
        "dscale", "dbias"]
    for name, a, b_ in zip(names, got, want):
        assert a.dtype == b_.dtype
        _assert_rel(a, b_, _ln_rel(name, dtype), name)


# K4-bwd against its plain version, relative to the largest entry. dx: f32
# the same formulas in other summation orders, bf16 and f16 rounded to
# their dtype (one ulp is 2^-8 and 2^-11 relative). dscale and dbias are
# f32 sums of the same f32 products in every dtype
LN_DX_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3,
             torch.float64: 1e-5}
LN_PARAM_REL = 1e-5


def _ln_rel(name, dtype):
    return LN_PARAM_REL if name in ("dscale", "dbias") else LN_DX_REL[dtype]


def _ln_case(card, dtype, shape, with_residual, seed=3):
    g = torch.Generator(device=card).manual_seed(seed)
    hidden = shape[-1]
    x = (2.0 * torch.randn(*shape, device=card, generator=g) + 0.5).to(dtype)
    res = (torch.randn(*shape, device=card, generator=g).to(dtype)
           if with_residual else None)
    w = 1.0 + 0.1 * torch.randn(hidden, device=card, generator=g)
    bias = 0.1 * torch.randn(hidden, device=card, generator=g)
    dy = torch.randn(*shape, device=card, generator=g).to(dtype)
    return x, res, w, bias, dy


# the main path's width (one warp a row, 3 or 6 vectors a lane), 1024 (4
# or 8), lanes without a vector (200), widths that end inside a 16-byte
# vector (204, 37), rows held by 4 and 8 warps, rows wider than 8192 (one
# block a row, in passes; the last also ragged), and the training step's
# 14592 rows
LN_BWD_SHAPES = [(4, 57, 768), (4, 57, 1024), (3, 41, 200), (3, 7, 204),
                 (2, 5, 37), (5, 33, 4096), (2, 9, 8192), (3, 5, 12288),
                 (2, 3, 20002), (14592, 768)]
# the grid's edges on an H100 (132 SMs, one block an SM at these widths,
# several at the narrow ones): one row, an SM's worth of rows and two, the
# parent kernel's pass of 2112 rows, LXMERT's 2304, each +- 1; and
# VisualBERT's and ViLT's rows. At the main paths' widths, 1024, narrow
# and ragged rows, and rows of 4 and 8 warps
LN_BWD_EDGE_ROWS = [1, 131, 132, 133, 263, 264, 265, 2111, 2112, 2113, 2303,
                    2304, 2305, 14592, 39488]
LN_BWD_SHAPES += [(rows, hidden) for hidden in (768, 1024, 200, 37, 4096,
                                                8192)
                  for rows in LN_BWD_EDGE_ROWS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("shape", LN_BWD_SHAPES)
def test_layer_norm_backward_kernel_matches_plain(card, dtype, with_residual,
                                                  shape):
    """K4-bwd at any width: dx, dscale and dbias against the plain
    backward; one launch a call; calls back to back, and calls on two
    streams at once, give the same bits (no float atomics; the scratch
    of each stream resets itself)."""
    x, res, w, bias, dy = _ln_case(card, dtype, shape, with_residual)
    before = L.layer_norm_backward_kernel.launches
    dx, dw, db = L.layer_norm_backward_kernel(x, w, dy, res)
    again = L.layer_norm_backward_kernel(x, w, dy, res)
    side = [torch.cuda.Stream(card) for _ in range(2)]
    for s in side:
        s.wait_stream(torch.cuda.current_stream(card))
    streamed = []
    for _ in range(2):
        for s in side:
            with torch.cuda.stream(s):
                streamed.append(L.layer_norm_backward_kernel(x, w, dy, res))
    torch.cuda.synchronize()
    assert L.layer_norm_backward_kernel.launches == before + 6
    for other in [again] + streamed:
        for first, second in zip((dx, dw, db), other):
            assert torch.equal(first, second)
    want = L._ln_backward_reference(x, res, w, bias, dy, 1e-12)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dw.dtype == db.dtype == torch.float32
    for name, got, ref in zip(("dx", "dscale", "dbias"), (dx, dw, db),
                              (want[0], want[2], want[3])):
        _assert_rel(got, ref, _ln_rel(name, dtype), name)


@pytest.mark.parametrize("dtype,residual_dtype", [
    (torch.float64, None), (torch.float64, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float16, torch.float16)])
def test_layer_norm_autograd_takes_any_float_dtypes(card, dtype,
                                                    residual_dtype):
    """layer_norm's backward on the card at a ragged width (204) in dtypes
    K4-bwd does not read natively (it then runs in f32 on x + residual)
    and in f16: one K4-bwd launch, the gradients of the plain backward in
    each input's dtype."""
    x, _, w, bias, dy = _ln_case(card, dtype, (3, 7, 204), False)
    res = None
    if residual_dtype is not None:
        res = torch.randn(x.shape, device=card, dtype=residual_dtype,
                          generator=torch.Generator(card).manual_seed(4))
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, res, w, bias) if t is not None]
    xi, *rest = leaves
    ri = rest.pop(0) if res is not None else None
    before = L.layer_norm_backward_kernel.launches
    L.layer_norm(xi, rest[0], rest[1], ri).backward(dy)
    torch.cuda.synchronize()
    assert L.layer_norm_backward_kernel.launches == before + 1
    want = [g for g in L._ln_backward_reference(x, res, w, bias, dy, 1e-12)
            if g is not None]
    names = ["dx"] + (["dresidual"] if res is not None else []) + [
        "dscale", "dbias"]
    dtypes = {"dx": dtype, "dresidual": residual_dtype}
    for name, leaf, ref in zip(names, leaves, want):
        assert leaf.grad.dtype == ref.dtype
        _assert_rel(leaf.grad, ref, _ln_rel(name, dtypes.get(name)), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_with_a_shared_residual(card, no_tf32, dtype):
    """The trunk's pattern: ``hidden`` is both the residual of the output
    LayerNorm and the input of the projections, so autograd adds the
    backward's dresidual (the dx tensor itself) to the projections'
    gradients. hidden's gradient against the same graph through the plain
    forward."""
    g = torch.Generator(device=card).manual_seed(9)
    hidden = torch.randn(4, 33, 768, device=card, generator=g).to(dtype)
    proj = 0.05 * torch.randn(768, 768, device=card, generator=g).to(dtype)
    w = 1.0 + 0.1 * torch.randn(768, device=card, generator=g)
    bias = 0.1 * torch.randn(768, device=card, generator=g)
    dy = torch.randn(4, 33, 768, device=card, generator=g).to(dtype)

    def hidden_grad(ln):
        h = hidden.detach().clone().requires_grad_()
        q = h @ proj  # a projection that reads hidden
        out = ln(q @ proj.t(), w, bias, h)  # residual = hidden
        (out.float() * dy.float()).sum().backward(
            inputs=[h], retain_graph=False)
        return h.grad

    before = L.layer_norm_backward_kernel.launches
    got = hidden_grad(L.layer_norm)
    torch.cuda.synchronize()
    assert L.layer_norm_backward_kernel.launches == before + 1
    want = hidden_grad(lambda x_, w_, b_, r_: L._ln_reference(
        x_, r_, w_, b_, 1e-12))
    # two products and the LayerNorm's gradient added: bf16 rounds each
    _assert_rel(got, want, 1e-4 if dtype == torch.float32 else 2e-2,
                "d hidden")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 36, 100])
def test_attention_pads_the_head_dim(card, no_tf32, dtype, d):
    """A head dim that is not a multiple of 8 runs the kernels zero-padded
    (K1 without a gradient; K1-stats, K2 and K3 with one), against the
    plain version at the true head dim."""
    q, k, v, bias, dout = _bwd_case(card, dtype, 2, 3, 40, 70, d, seed=4)
    before = A.flash_attention.launches
    out = A.dot_product_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    assert out.shape == q.shape
    torch.testing.assert_close(out, A.mha_reference(q, k, v, bias),
                               **TOL[dtype])
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    counts = (A.flash_attention_with_stats.launches,
              A.flash_attention_bwd_dq.launches,
              A.flash_attention_bwd_dkv.launches)
    A.dot_product_attention(*leaves, bias).backward(dout)
    torch.cuda.synchronize()
    assert (A.flash_attention_with_stats.launches,
            A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    A.mha_reference(*ref_leaves, bias).backward(dout.float())
    for name, got, want in zip("qkv", leaves, ref_leaves):
        assert got.grad.shape == want.grad.shape
        _assert_rel(got.grad, want.grad, 1.5 * GRAD_REL[dtype], "d" + name)


def test_attention_refuses_head_dims_over_128(card):
    """bf16 above 128 and f32 above 256 raise (f32 up to 256 runs the wide
    kernels); so does the raw-stats form above 128."""
    q = torch.randn(1, 2, 9, 136, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 kernels take head dims up "
                                         "to 128"):
        A.dot_product_attention(q, q, q)
    with pytest.raises(ValueError, match="head dims 1 to 256"):
        q = torch.randn(1, 2, 9, 264, device=card)
        A.dot_product_attention(q, q, q)
    q = torch.randn(1, 2, 9, 136, device=card)
    with pytest.raises(ValueError, match="raw-stats form takes head dims"):
        A.flash_attention_block(q, q, q)


# mmf_bert's f32 attention (8 heads of 96): the text self-attention over
# 128 tokens, the regions' intra-attention over 100, the text's queries over
# the regions; multihead's one question row over 100 regions (8 heads of
# 256, the wide kernels); the wide kernels at 136 and 160 and at several
# ring tiles; D = 96's third 32-column box is the TF32 kernels' partly
# used 64-column block
PYTHIA2_SHAPES = [(2, 8, 128, 128, 96), (2, 8, 100, 100, 96),
                  (2, 8, 128, 100, 96), (4, 8, 1, 100, 256),
                  (2, 3, 37, 70, 136), (2, 2, 40, 130, 160),
                  (1, 2, 130, 65, 256)]
# the wide kernels' edges at D = 256: q rows of one 16-row block or not, or
# one row into the next, against kv of one row, a 32-row ring tile, a
# ragged second, several tiles
WIDE_EDGE_SHAPES = [(2, 2, sq, skv, 256) for sq in (1, 2, 15, 16, 17)
                    for skv in (1, 31, 32, 33, 100, 130)]


@pytest.mark.parametrize("shape", PYTHIA2_SHAPES + WIDE_EDGE_SHAPES)
def test_pythia2_shapes_match_plain(card, no_tf32, shape):
    """K1 in its inference and stats forms, K2 and K3 in f32 at mmf_bert's
    and multihead's shapes and the wide kernels' edges, with a padding
    bias (and, at two batches, one batch whose every key is -inf), against
    their plain versions (the f32 bounds above); through autograd too."""
    b, h, sq, skv, d = shape
    q, k, v, bias, dout = _bwd_case(card, torch.float32, *shape,
                                    seed=sq * 1000 + skv)
    out = A.flash_attention(q, k, v, bias)
    out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
    dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
    torch.cuda.synchronize()
    ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
    torch.testing.assert_close(out, ref_out, **TOL[torch.float32])
    assert torch.equal(out, out_s)
    torch.testing.assert_close(m, ref_m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, ref_l, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(delta, (dout * out).sum(-1), atol=1e-3,
                               rtol=1e-4)
    want = A.flash_backward_reference(q, k, v, bias, out_s, m, l, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        # one key: p = 1 and ds = dp - delta cancels, so dq and dk are
        # zero but for rounding and no relative bound holds them
        if skv > 1 or name == "dv":
            _assert_rel(got, ref, GRAD_REL[torch.float32], name)
    if b > 1:  # the -inf batch: zero outputs and gradients, not NaN
        assert (out[-1] == 0).all() and (dq[-1] == 0).all()
        assert (dk[-1] == 0).all() and (dv[-1] == 0).all()
    # through autograd: K2 and K3 on v and the output centred on v's mean
    # row (the same ds; dv bit-equal)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = A.flash_attention_bwd_dkv.launches
    A.dot_product_attention(*leaves, bias).backward(dout)
    torch.cuda.synchronize()
    assert A.flash_attention_bwd_dkv.launches == before + 1
    assert torch.equal(leaves[2].grad, dv)
    for name, got, ref in zip(("dq", "dk"), leaves[:2], want[:2]):
        if skv > 1:
            _assert_rel(got.grad, ref, GRAD_REL[torch.float32], name)


@pytest.mark.parametrize("shape", [(2, 8, 128, 100, 96), (4, 8, 1, 100, 256),
                                   (2, 12, 128, 100, 64)])
def test_f32_backward_resolves_nearly_alike_values(card, no_tf32, shape):
    """Values whose rows differ by 1% (mmf_bert's cross-attention reads
    another attention's output): dp = dO v^T and delta nearly cancel in
    ds; the backward through autograd (v and the output centred on v's
    mean row) holds dq, dk and dv to float64 within the f32 bound."""
    b, h, sq, skv, d = shape
    g = torch.Generator(device=card).manual_seed(sq + d)
    q, k, _, bias, dout = _bwd_case(card, torch.float32, b, h, sq, skv, d,
                                    seed=5)
    common = torch.randn(b, h, 1, d, device=card, generator=g)
    v = common + 0.01 * torch.randn(b, h, skv, d, device=card, generator=g)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    A.dot_product_attention(*leaves, bias).backward(dout)
    ref = [t.detach().double().requires_grad_() for t in (q, k, v)]
    A.mha_reference(*ref, bias.double()).backward(dout.double())
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), leaves, ref):
        _assert_rel(got.grad, want.grad, GRAD_REL[torch.float32], name)


@pytest.mark.parametrize("shape", [(2, 8, 128, 100, 128),
                                   (2, 12, 128, 100, 64)])
def test_bf16_backward_resolves_nearly_alike_values(card, shape):
    """The bf16 form of the test above, at ViLBERT's co-attention (D =
    128) and the main path's head dim: values whose rows differ by 1%,
    the backward through autograd (the bf16 K2 takes delta from dO and
    the forward's output; centred_values passes bf16 through) holds dq,
    dk and dv to float64 on the same bf16 inputs within the bf16
    bound."""
    b, h, sq, skv, d = shape
    g = torch.Generator(device=card).manual_seed(sq + d)
    q, k, _, bias, dout = _bwd_case(card, torch.bfloat16, b, h, sq, skv, d,
                                    seed=5)
    common = torch.randn(b, h, 1, d, device=card, generator=g)
    v = (common + 0.01 * torch.randn(b, h, skv, d, device=card,
                                     generator=g)).to(torch.bfloat16)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = (A.flash_attention_bwd_dq.launches,
              A.flash_attention_bwd_dkv.launches)
    A.dot_product_attention(*leaves, bias).backward(dout)
    ref = [t.detach().double().requires_grad_() for t in (q, k, v)]
    A.mha_reference(*ref, bias.double()).backward(dout.double())
    torch.cuda.synchronize()
    assert (A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                    before[1] + 1)
    for name, got, want in zip(("dq", "dk", "dv"), leaves, ref):
        _assert_rel(got.grad, want.grad, GRAD_REL[torch.bfloat16], name)


@pytest.mark.parametrize("shape", [(4, 8, 1, 100, 256),
                                   (2, 8, 128, 100, 96)])
def test_pythia2_backward_is_bit_equal_across_calls(card, shape):
    """Two backward calls give the same bits at multihead's and mmf_bert's
    shapes (no atomics in either design)."""
    q, k, v, bias, dout = _bwd_case(card, torch.float32, *shape, seed=9)
    out, m, l = A.flash_attention_with_stats(q, k, v, bias)
    first = A.flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout)
    first += A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, first[1])
    second = A.flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout)
    second += A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, second[1])
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("k", [40, 100, 776])
def test_int8_dense_pads_k(card, k):
    """A K that is not a multiple of 16 runs K5 on zero-padded operands:
    one launch, the plain version's result on the unpadded ones."""
    g = torch.Generator(device=card).manual_seed(k)
    x = torch.randn(37, k, device=card, generator=g)
    wt = 0.05 * torch.randn(24, k, device=card, generator=g)
    b = torch.randn(24, device=card, generator=g)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = Q.dequant_gemm.launches
        out = Q.int8_dense(x, wt, b, out_dtype)
        torch.cuda.synchronize()
        assert Q.dequant_gemm.launches == before + 1
        x8, xs = Q.quantize_rows(x)
        w8, ws = Q.quantize_rows(wt, eps=1e-11)
        scaled = Q.dequant_gemm_reference(x8, w8, xs.reshape(-1),
                                          ws.reshape(-1), None, torch.float32)
        ref = Q.dequant_gemm_reference(x8, w8, xs.reshape(-1),
                                       ws.reshape(-1), b, out_dtype)
        err = (out.float() - ref.float()).abs()
        assert (err <= _k5_bound(scaled, b, ref, out_dtype)).all()


def test_training_forward_routes_attention_dropout_to_plain(card):
    """Attention-probability dropout above 0 in training goes to
    mha_reference with the step's CUDA generator (no attention kernel
    launch), as in JAX; the masks repeat with the seed and the gradients
    are finite."""
    from mmf_tpu_torch.modules.transformer import dropout_generator
    from mmf_tpu_torch.utils.flagship import example_batch, visual_bert

    model = visual_bert({"num_hidden_layers": 2, "hidden_size": 64,
                         "num_attention_heads": 4, "intermediate_size": 128,
                         "visual_embedding_dim": 32, "num_labels": 5,
                         "hidden_dropout_prob": 0.1,
                         "attention_probs_dropout_prob": 0.2})
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(card).train()
    batch = example_batch(2, 8, 4, 32, vocab_size=1000, seed=0)
    batch = {k: ({kk: torch.from_numpy(vv).to(card) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v).to(card))
             for k, v in batch.items()}

    def scores(seed):
        with dropout_generator(torch.Generator(device=card).manual_seed(
                seed)):
            return model(batch)["scores"]

    counts = (A.flash_attention.launches,
              A.flash_attention_with_stats.launches)
    out = scores(1)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (A.flash_attention.launches,
            A.flash_attention_with_stats.launches) == counts
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
    with torch.no_grad():
        torch.testing.assert_close(scores(1), scores(1), rtol=0, atol=0)
        assert not torch.equal(scores(1), scores(2))


# K5 shapes (M, K, N) with the output tile k5_tile picks: MMBT's pooler and
# trunk at batch 1 (M = 1, 131) on 64 x 64 tiles, VisualBERT at bucket 32
# (M = 7296, and its visual projection's M = 3200) on 128 x 128; ragged
# edges: M, N not multiples of the tiles (odd N included: no 16-byte chunks
# in the epilogue's copy), K = 16 and 48 (one partial 128-byte slab)
K5_SHAPES = [((1, 768, 768), 64), ((131, 768, 3072), 64),
             ((131, 3072, 768), 64), ((7296, 768, 3072), 128),
             ((37, 48, 70), 64), ((65, 16, 9), 64), ((64, 48, 70), 64),
             ((131, 768, 768), 64), ((131, 256, 130), 64),
             ((3200, 2048, 768), 128), ((7296, 3072, 771), 128)]


def _k5_bound(ref_scaled, bias, ref, out_dtype):
    """Allowed error per entry: f32 within 2 ulp of the epilogue's
    operands (|y xs ws| + |b|), bf16 within 1 bf16 ulp of the plain
    result."""
    if out_dtype == torch.float32:
        return 2.0 ** -22 * (ref_scaled.abs()
                             + (0 if bias is None else bias.abs()))
    _, exponent = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref.float()), exponent - 8)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tile", K5_SHAPES)
def test_int8_gemm_matches_plain(card, out_dtype, shape, tile):
    """K5 at both output tiles against its plain version; one launch a
    call; a second call gives the same bits."""
    m, k, n = shape
    assert Q.k5_tile(m, n) == tile
    g = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn(m, k, device=card, generator=g)
    w = 0.02 * torch.randn(n, k, device=card, generator=g)
    x8, xs = Q.quantize_rows(x)
    w8, ws = Q.quantize_rows(w, eps=1e-11)
    xs, ws = xs.reshape(-1), ws.reshape(-1)
    for bias in (None, 0.1 * torch.randn(n, device=card, generator=g)):
        before = Q.dequant_gemm.launches
        out = Q.dequant_gemm(x8, w8, xs, ws, bias, out_dtype)
        again = Q.dequant_gemm(x8, w8, xs, ws, bias, out_dtype)
        torch.cuda.synchronize()
        assert Q.dequant_gemm.launches == before + 2
        assert torch.equal(out, again)
        assert out.dtype == out_dtype and out.shape == (m, n)
        ref = Q.dequant_gemm_reference(x8, w8, xs, ws, bias, out_dtype)
        scaled = Q.dequant_gemm_reference(x8, w8, xs, ws, None,
                                          torch.float32)
        err = (out.float() - ref.float()).abs()
        assert (err <= _k5_bound(scaled, bias, ref, out_dtype)).all(), \
            float(err.max())


def test_int8_gemm_takes_views_and_refuses_bad_k(card):
    g = torch.Generator(device=card).manual_seed(7)
    x8 = torch.randint(-127, 128, (40, 80), device=card, generator=g,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (24, 80), device=card, generator=g,
                       dtype=torch.int8)
    xs, ws = torch.rand(40, device=card), torch.rand(24, device=card)
    # an offset, strided view is copied to an aligned operand
    view = x8[:, 16:]
    out = Q.dequant_gemm(view, w8[:, 16:], xs, ws, None)
    ref = Q.dequant_gemm_reference(view, w8[:, 16:], xs, ws, None,
                                   torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2.4e-7, atol=0)
    before = Q.dequant_gemm.launches
    for k in (8, 24, Q.MAX_K + 16):
        with pytest.raises(ValueError, match="multiple of 16"):
            Q.dequant_gemm(torch.zeros(4, k, dtype=torch.int8, device=card),
                           torch.zeros(4, k, dtype=torch.int8, device=card),
                           torch.ones(4, device=card),
                           torch.ones(4, device=card), None)
    assert Q.dequant_gemm.launches == before


def test_quant_dense_runs_k5_on_the_card(card):
    """QuantDense on the card launches K5 once per call, never the plain
    version, and agrees with the same module on the CPU; its
    straight-through gradients match the CPU's."""
    layer = Q.QuantDense(96, 40, torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        layer.weight.normal_(0.0, 0.02, generator=g)
        layer.bias.normal_(0.0, 0.1, generator=g)
    x = torch.randn(3, 11, 96, generator=g).to(torch.bfloat16)
    cpu = layer(x)
    gpu_layer = Q.QuantDense(96, 40, torch.bfloat16).to(card)
    gpu_layer.load_state_dict(layer.state_dict())
    before = Q.dequant_gemm.launches
    xg = x.to(card).requires_grad_()
    out = gpu_layer(xg)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert Q.dequant_gemm.launches == before + 1
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.cpu(), cpu, rtol=2 ** -8, atol=1e-6)
    xc = x.clone().requires_grad_()
    layer(xc).float().sum().backward()
    torch.testing.assert_close(gpu_layer.weight.grad.cpu(), layer.weight.grad,
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(xg.grad.cpu().float(), xc.grad.float(),
                               rtol=1e-2, atol=1e-3)


# K1's three forms at the head dims the wgmma kernel boxes differently
# (D = 16 zero-padded to one 64-column box, 64 one box, 128 two), Sq != Skv
# with ragged tiles, and a long kv; a padding-mask row (stride 0 over
# heads and q rows) or a per-element bias, each with rows that have no
# finite score at all
FWD_SHAPES = [(2, 3, 100, 150, 16), (2, 3, 100, 150, 64),
              (2, 3, 100, 150, 128), (1, 2, 1024, 1024, 16),
              (1, 2, 1024, 1024, 64), (1, 2, 1024, 1024, 128)] + VILBERT_SHAPES + [
                  MMFT_SHAPE, MMBT_SHAPE]


def _fwd_case(card, dtype, shape, bias_kind, seed=11):
    b, h, sq, skv, d = shape
    q, k, v, _, _ = _bwd_case(card, dtype, b, h, sq, skv, d, seed=seed)
    g = torch.Generator(device=card).manual_seed(seed + 1)
    if bias_kind == "row":
        mask = (torch.rand(b, skv, device=card, generator=g) > 0.3).int()
        mask[:, 0] = 1
        bias = A.make_attention_bias(mask)
        bias[-1] = float("-inf")  # the last batch attends to nothing
        empty = torch.zeros(b, h, sq, dtype=torch.bool, device=card)
        empty[-1] = True
    else:
        bias = torch.randn(b, 1, sq, skv, device=card, generator=g)
        bias[..., 1::5] = float("-inf")
        bias[:, :, 3] = float("-inf")  # q row 3 attends to nothing
        empty = torch.zeros(b, h, sq, dtype=torch.bool, device=card)
        empty[:, :, 3] = True
    return q, k, v, bias, empty


@pytest.mark.parametrize("bias_kind", ["row", "element"])
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_flash_forward_forms_match_plain(card, no_tf32, shape, bias_kind):
    """K1's inference, stats and raw-stats forms (bf16, the wgmma kernel)
    against their plain versions; rows with no finite score give zeros
    (inference), parked m = 0, l = 1 (stats) and m = -inf, l = 0, acc = 0
    (raw); a second call gives the same bits."""
    dtype = torch.bfloat16
    q, k, v, bias, empty = _fwd_case(card, dtype, shape, bias_kind)
    counts = (A.flash_attention.launches,
              A.flash_attention_with_stats.launches,
              A.flash_attention_block.launches)
    runs = [[A.flash_attention(q, k, v, bias),
             *A.flash_attention_with_stats(q, k, v, bias),
             *A.flash_attention_block(q, k, v, bias)] for _ in range(2)]
    torch.cuda.synchronize()
    assert (A.flash_attention.launches,
            A.flash_attention_with_stats.launches,
            A.flash_attention_block.launches) == tuple(c + 2 for c in counts)
    for first, second in zip(*runs):
        assert torch.equal(first, second)
    out, out_s, m, l, acc, m_raw, l_raw = runs[0]
    ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out, ref_out, **TOL[dtype])
    assert torch.equal(out, out_s)
    torch.testing.assert_close(m, ref_m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, ref_l, atol=1e-4, rtol=1e-4)
    ref_acc, ref_mr, ref_lr = A.flash_attention_block_reference(q, k, v, bias)
    torch.testing.assert_close(m_raw, ref_mr, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l_raw, ref_lr, atol=1e-4, rtol=1e-4)
    _assert_rel(acc, ref_acc, 1e-2, "acc")
    assert empty.any()
    assert (out.float()[empty] == 0).all()
    assert (m[empty] == 0).all() and (l[empty] == 1).all()
    assert torch.isneginf(m_raw[empty]).all() and (l_raw[empty] == 0).all()
    assert (acc[empty] == 0).all()


def test_vilbert_forward_runs_the_kernels(card):
    """A ViLBERT at full width with fewer layers (4 text, 2 image, 2
    co-attention), bf16, through the kernels: per forward one K1 a text
    and an image layer and two a co-attention layer (text queries over
    the regions, region queries over the text, D = 128 with a padded
    tail), and a LayerNorm (K4) for each of the 2 + 2 + 4 residual sums
    of those layers, the text and image embeddings and the classifier
    transform; the scores against the same weights' f32 forward on the
    CPU (serving's bar: max abs 0.1, cosine 0.999)."""
    from mmf_tpu_torch.utils import flagship

    small = {"num_hidden_layers": 4, "v_num_hidden_layers": 2,
             "v_biattention_id": [0, 1], "t_biattention_id": [2, 3]}
    batch = flagship.vilbert_example_batch(4, seed=1)
    batch["image_info_0"]["max_features"][:] = [100, 37, 64, 99]
    model = flagship.vilbert(small)
    model.init_weights(torch.Generator().manual_seed(0))
    ref = flagship.vilbert(dict(small, dtype="float32"))
    ref.load_state_dict(model.state_dict(), strict=True)

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        return torch.from_numpy(tree).to(device)

    model = model.to(card).eval().to_compute_dtype()
    counts = (A.flash_attention.launches, L.layer_norm_kernel.launches)
    with torch.inference_mode():
        got = model(to(batch, card))["scores"].float().cpu()
        want = ref.eval()(to(batch, "cpu"))["scores"]
    torch.cuda.synchronize()
    assert (A.flash_attention.launches - counts[0],
            L.layer_norm_kernel.launches - counts[1]) == (
        4 + 2 + 2 * 2, 2 * 4 + 2 * 2 + 4 * 2 + 3)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 0.1
    cos = float(torch.nn.functional.cosine_similarity(
        got.flatten(), want.flatten(), dim=0))
    assert cos >= 0.999



def test_vilt_forward_and_step_run_the_kernels(card, no_tf32):
    """ViLT at full width with 2 layers, f32, through the kernels: per
    forward one K1 a layer and 2 * 2 + 3 LayerNorms (K4: the text
    embeddings', two a pre-LN layer, the encoder's last, the MLP
    head's); a backward adds one K1-stats, K2 and K3 a layer and a K4-bwd
    a LayerNorm. The scores against the same weights' f32 forward on the
    CPU, TF32 off in cuBLAS and cuDNN (the patch convolution)."""
    import dataclasses

    from mmf_tpu_torch.modules import transformer as T
    from mmf_tpu_torch.utils import flagship

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = flagship.vilt_vqa2_config()
        model = flagship.vilt(cfg, {"num_hidden_layers": 2})
        model.init_weights(torch.Generator().manual_seed(0))
        ref = flagship.vilt(cfg, {"num_hidden_layers": 2})
        ref.load_state_dict(model.state_dict(), strict=True)
        batch = flagship.vilt_train_batch(2, seed=1)
        meta = {"dataset_name": "vqa2", "dataset_type": "train"}

        def to(device):
            return dict({k: torch.from_numpy(v).to(device)
                         for k, v in batch.items()}, **meta)

        model = model.to(card).eval()
        counts = {f: f.launches for f in (
            A.flash_attention, A.flash_attention_with_stats,
            A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv,
            L.layer_norm_kernel, L.layer_norm_backward_kernel)}
        with torch.inference_mode():
            got = model(to(card))["scores"].cpu()
            want = ref.eval()(to("cpu"))["scores"]
        torch.cuda.synchronize()
        assert A.flash_attention.launches - counts[A.flash_attention] == 2
        assert L.layer_norm_kernel.launches - counts[
            L.layer_norm_kernel] == 7
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
        # attention-probability dropout would take the plain path
        for m in model.modules():
            if isinstance(getattr(m, "config", None), T.TransformerConfig):
                m.config = dataclasses.replace(
                    m.config, attention_probs_dropout_prob=0.0)
        with T.dropout_generator(torch.Generator(device=card).manual_seed(0)):
            out = model.train()(to(card))
        sum(out["losses"].values()).backward()
        torch.cuda.synchronize()
        for f, n in ((A.flash_attention_with_stats, 2),
                     (A.flash_attention_bwd_dq, 2),
                     (A.flash_attention_bwd_dkv, 2),
                     (L.layer_norm_backward_kernel, 7)):
            assert f.launches - counts[f] == n, f
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
