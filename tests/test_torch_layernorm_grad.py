"""LayerNorm gradients of the port (autograd through ``layer_norm``, and
the backward of ``LayerNormFunction``, the kernel's autograd wrapper)
against ``jax.grad`` through the JAX package's ``_ln_pallas`` (its Pallas
kernel in interpret mode, whose VJP recomputes through ``_ln_reference``),
with and without the fused residual, on the same numpy inputs."""

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
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def jax_loss(x_, r_, s_, b_):
        y = jln._ln_pallas(x_, r_, s_, b_, 1e-12, True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    jargs = [jnp.asarray(x, jdt), None if res is None else jnp.asarray(
        res, jdt), jnp.asarray(scale), jnp.asarray(bias)]
    argnums = (0, 1, 2, 3) if with_residual else (0, 2, 3)
    want = jax.grad(jax_loss, argnums=argnums)(*jargs)

    leaves = [torch.from_numpy(x).to(tdt),
              None if res is None else torch.from_numpy(res).to(tdt),
              torch.from_numpy(scale), torch.from_numpy(bias)]
    leaves = [None if t is None else t.requires_grad_() for t in leaves]
    xt, rt, st, bt = leaves
    tln.layer_norm(xt, st, bt, residual=rt, eps=1e-12).backward(
        torch.from_numpy(dy).to(tdt))
    # the kernel's Function computes its backward the same way
    fleaves = [None if t is None else t.detach().clone().requires_grad_()
               for t in leaves]
    y = tln.LayerNormFunction.backward(_Ctx(fleaves), torch.from_numpy(dy)
                                       .to(tdt))
    got = [t.grad for t in leaves if t is not None]
    fgot = [g for g in y[:4] if g is not None]
    for g, f, w in zip(got, fgot, want):
        assert g.dtype == f.dtype
        assert _rel_err(g.float().numpy(), w) < GRAD_REL[dtype]
        assert _rel_err(f.float().numpy(), w) < GRAD_REL[dtype]


class _Ctx:
    """What ``LayerNormFunction.forward`` leaves on its context."""

    def __init__(self, leaves):
        self.saved_tensors = tuple(leaves)
        self.eps = 1e-12
