"""LayerNorm(x [+ residual]): the hand-written Triton kernel and its plain
PyTorch version.

Port of ``mmf_tpu/ops/layernorm.py``. Semantics: statistics and the
affine transform in f32 whatever the input dtype, scale and bias f32, the
output in x's dtype.

- ``layer_norm_kernel``: wrapper of the Triton kernel in
  ``ops/layernorm_triton.py``, which replaces the Pallas TPU kernels
  ``mmf_tpu/ops/layernorm.py::_ln_kernel`` and ``_res_ln_kernel`` (both
  forms, the residual add fused). CUDA tensors only: it launches or
  raises. On the H100 it is bound by device-memory bandwidth (no matrix
  product; ~8 FLOPs per element against 4-6 bytes moved): one program
  reads one whole row (and its residual) once, keeps the sum and the
  centred sum of squares in registers, and writes only the output.
- ``LayerNormFunction``: the autograd Function over the kernel, the
  counterpart of the JAX ``_ln_pallas`` custom_vjp: the forward is the
  Triton kernel; the backward recomputes through ``_ln_reference`` and
  takes its VJP, as JAX does (JAX has no Pallas backward for LayerNorm).
- ``_ln_reference``: the plain version, used for CPU tensors.
- ``layer_norm``: CUDA tensors go to the kernel (through
  ``LayerNormFunction`` when a gradient is wanted), CPU tensors to the
  plain version. Unlike the JAX package, where the Pallas kernel is opt-in
  (``MMF_TPU_LN``), the port always takes its kernel on the card; whether
  it should is measured in ``PERF.md``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from mmf_tpu_torch.ops._build import BUILD_ROOT


def _ln_reference(x, residual, scale, bias, eps):
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = torch.square(h - mean).mean(dim=-1, keepdim=True)
    y = (h - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_kernel(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
) -> torch.Tensor:
    """LayerNorm on the card through the Triton kernel. x (and residual,
    same shape) of any float dtype with the normalised dim last; scale
    and bias [hidden]. Returns x's shape and dtype."""
    if not x.is_cuda:
        raise RuntimeError(
            f"layer_norm_kernel is a GPU kernel: x is on {x.device}. CPU "
            "tensors go through _ln_reference (layer_norm dispatches by "
            "device)."
        )
    hidden = x.shape[-1]
    if hidden > 65536:
        raise ValueError(f"hidden size {hidden} exceeds one-row blocks")
    x2d = x.reshape(-1, hidden).contiguous()
    r2d = None
    if residual is not None:
        if residual.shape != x.shape or residual.device != x.device:
            raise ValueError(
                f"residual {tuple(residual.shape)} on {residual.device} "
                f"does not match x {tuple(x.shape)} on {x.device}"
            )
        r2d = residual.reshape(-1, hidden).contiguous()
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (hidden,) or p.device != x.device:
            raise ValueError(
                f"{name} must be [{hidden}] on {x.device}, got "
                f"{tuple(p.shape)} on {p.device}"
            )
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    y = torch.empty_like(x2d)
    if x2d.shape[0] > 0:
        # Triton's compiled kernels go under build/ with nvcc's output
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(BUILD_ROOT, "triton"))
        from mmf_tpu_torch.ops import layernorm_triton

        with torch.cuda.device(x.device):
            layernorm_triton.launch(x2d, r2d, scale, bias, y, float(eps))
        layer_norm_kernel.launches += 1
    return y.view(x.shape)


layer_norm_kernel.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """Forward: the Triton kernel. Backward: the VJP of ``_ln_reference``
    recomputed from the saved inputs (``_ln_pallas_bwd`` in JAX)."""

    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps):
        ctx.save_for_backward(x, residual, scale, bias)
        ctx.eps = eps
        return layer_norm_kernel(x, scale, bias, residual, eps)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in saved]
        x, residual, scale, bias = leaves
        with torch.enable_grad():
            y = _ln_reference(x, residual, scale, bias, ctx.eps)
        inputs = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(y, inputs, grad))
        return (*(None if t is None else next(grads) for t in leaves),
                None)


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
) -> torch.Tensor:
    """LayerNorm(x [+ residual]) with f32 statistics, output in x.dtype:
    the Triton kernel for CUDA tensors, the plain version for CPU ones."""
    if not x.is_cuda:
        return _ln_reference(x, residual, scale, bias, eps)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, residual, scale, bias)):
        return LayerNormFunction.apply(x, residual, scale, bias, eps)
    return layer_norm_kernel(x, scale, bias, residual, eps)
