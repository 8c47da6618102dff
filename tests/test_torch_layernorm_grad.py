"""LayerNorm gradients of the port (autograd through ``layer_norm``, the
backward of ``LayerNormFunction``, the kernels' autograd wrapper, and
``_ln_backward_reference``, the plain version of the backward kernel
K4-bwd) against ``jax.grad`` through the JAX package's ``_ln_pallas`` (its
Pallas kernel in interpret mode, whose VJP recomputes through
``_ln_reference``), with and without the fused residual, on the same numpy
inputs; and how K4-bwd's wrapper lays out rows and dtypes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmf_tpu.ops import layernorm as jln
from mmf_tpu_torch.ops import layernorm as tln

torch.set_num_threads(2)  # several test workers share the host

# max abs error over the largest reference entry: the same f32 formulas in
# another summation order; bf16 inputs give bf16 dx (one ulp 2^-8)
GRAD_REL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(seed, shape, with_residual):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if with_residual else None
    scale = (1.0 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x, res, scale, bias, dy


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_layer_norm_grads_match_jax_pallas(dtype, with_residual):
    x, res, scale, bias, dy = _inputs(4, (2, 9, 256), with_residual)
    want = [w for w in _jax_grads(x, res, scale, bias, dy, dtype)
            if w is not None]
    *leaves, dyt = _torch_args(x, res, scale, bias, dy, dtype)
    leaves = [None if t is None else t.requires_grad_() for t in leaves]
    xt, rt, st, bt = leaves
    tln.layer_norm(xt, st, bt, residual=rt, eps=1e-12).backward(dyt)
    # the kernels' Function computes its backward the same way
    fleaves = [None if t is None else t.detach().clone().requires_grad_()
               for t in leaves]
    y = tln.LayerNormFunction.backward(_Ctx(fleaves), dyt)
    got = [t.grad for t in leaves if t is not None]
    fgot = [g for g in y[:4] if g is not None]
    for g, f, w in zip(got, fgot, want):
        assert g.dtype == f.dtype
        assert _rel_err(g.float().numpy(), w) < GRAD_REL[dtype]
        assert _rel_err(f.float().numpy(), w) < GRAD_REL[dtype]


class _Ctx:
    """What ``LayerNormFunction.forward`` and autograd leave on its
    context."""

    def __init__(self, leaves):
        self.saved_tensors = tuple(leaves)
        self.eps = 1e-12
        self.needs_input_grad = tuple(t is not None for t in leaves) + (
            False,)


def _jax_grads(x, res, scale, bias, dy, dtype):
    """jax.grad through ``_ln_pallas(interpret=True)``: (dx, dres or None,
    dscale, dbias) as float32 numpy arrays."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def loss(x_, r_, s_, b_):
        y = jln._ln_pallas(x_, r_, s_, b_, 1e-12, True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    args = [jnp.asarray(x, jdt), None if res is None else jnp.asarray(
        res, jdt), jnp.asarray(scale), jnp.asarray(bias)]
    argnums = (0, 1, 2, 3) if res is not None else (0, 2, 3)
    got = [np.asarray(g, np.float32)
           for g in jax.grad(loss, argnums=argnums)(*args)]
    return got if res is not None else [got[0], None, *got[1:]]


def _torch_args(x, res, scale, bias, dy, dtype):
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(x).to(tdt),
            None if res is None else torch.from_numpy(res).to(tdt),
            torch.from_numpy(scale), torch.from_numpy(bias),
            torch.from_numpy(dy).to(tdt))


@pytest.mark.parametrize("shape", [(2, 9, 768), (2, 9, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_backward_reference_matches_jax_pallas(shape, dtype, with_residual):
    """``_ln_backward_reference``, the closed form K4-bwd computes: dx,
    dresidual, dscale and dbias against JAX's VJP, in the dtypes JAX gives
    them."""
    x, res, scale, bias, dy = _inputs(7, shape, with_residual)
    want = _jax_grads(x, res, scale, bias, dy, dtype)
    xt, rt, st, bt, dyt = _torch_args(x, res, scale, bias, dy, dtype)
    got = tln._ln_backward_reference(xt, rt, st, bt, dyt, 1e-12)
    assert got[0].dtype == xt.dtype and got[0].shape == xt.shape
    assert got[2].dtype == got[3].dtype == torch.float32
    assert got[2].shape == got[3].shape == (shape[-1],)
    if rt is None:
        assert got[1] is None
    else:
        assert got[1].dtype == rt.dtype
        assert torch.equal(got[1], got[0])  # one gradient, both inputs
    for name, g, w in zip(("dx", "dresidual", "dscale", "dbias"), got, want):
        if w is not None:
            err = _rel_err(g.float().numpy(), w)
            assert err < GRAD_REL[dtype], (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_function_backward_on_cpu_is_the_plain_backward(dtype,
                                                        with_residual):
    """On CPU tensors ``LayerNormFunction.backward`` returns the plain
    backward's gradients, only where the context asks for them."""
    x, res, scale, bias, dy = _inputs(8, (3, 5, 64), with_residual)
    xt, rt, st, bt, dyt = _torch_args(x, res, scale, bias, dy, dtype)
    want = tln._ln_backward_reference(xt, rt, st, bt, dyt, 1e-12)
    ctx = _Ctx([xt, rt, st, bt])
    got = tln.LayerNormFunction.backward(ctx, dyt)
    assert len(got) == 5 and got[4] is None
    for g, w in zip(got[:4], want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
    ctx.needs_input_grad = (False, with_residual, True, False, False)
    got = tln.LayerNormFunction.backward(ctx, dyt)
    assert got[0] is None and got[3] is None and torch.equal(got[2], want[2])
    assert (got[1] is None) != with_residual


@pytest.mark.parametrize("hidden,dtype,stride", [
    (768, torch.bfloat16, 768), (768, torch.float32, 768),
    (200, torch.bfloat16, 200), (204, torch.bfloat16, 208),
    (204, torch.float32, 204), (202, torch.float32, 204),
    (100, torch.float16, 104), (1, torch.bfloat16, 8),
    (9, torch.float32, 12), (8200, torch.bfloat16, 8200),
    (20002, torch.float32, 20004),
])
def test_row_stride(hidden, dtype, stride):
    """K4-bwd reads rows of whole 16-byte vectors: a ragged width is
    zero-padded to the next one."""
    assert tln.row_stride(hidden, dtype) == stride


@pytest.mark.parametrize("dtype,residual_dtype", [
    (torch.float32, None), (torch.bfloat16, torch.bfloat16),
    (torch.float16, None), (torch.float64, None),
    (torch.float64, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float16, torch.bfloat16),
])
def test_kernel_operands_keep_the_gradient(dtype, residual_dtype):
    """What K4-bwd reads: the inputs themselves where it reads their dtype,
    else x + residual and dy in f32. The plain backward of those, cast to
    each input's dtype, is the plain backward of the inputs, bit for
    bit."""
    x, res, scale, bias, dy = _inputs(9, (3, 5, 40), residual_dtype
                                      is not None)
    xt = torch.from_numpy(x).to(dtype)
    rt = None if res is None else torch.from_numpy(res).to(residual_dtype)
    dyt = torch.from_numpy(dy).to(dtype)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    kx, kr, kdy = tln.kernel_operands(xt, rt, dyt)
    native = dtype != torch.float64 and residual_dtype in (None, dtype)
    if native:
        assert kx is xt and kr is rt and kdy is dyt
    else:
        assert kx.dtype == kdy.dtype == torch.float32 and kr is None
    want = tln._ln_backward_reference(xt, rt, st, bt, dyt, 1e-12)
    dh, _, dscale, dbias = tln._ln_backward_reference(kx, kr, st, bt, kdy,
                                                      1e-12)
    assert torch.equal(dh.to(dtype), want[0])
    if rt is not None:
        assert torch.equal(dh.to(residual_dtype), want[1])
    assert torch.equal(dscale, want[2]) and torch.equal(dbias, want[3])
