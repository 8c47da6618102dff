"""LayerNorm(x [+ residual]): the hand-written kernels (a Triton forward,
a CUDA backward) and their plain PyTorch versions.

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
- ``layer_norm_backward_kernel``: wrapper of the CUDA C++ kernel
  ``ops/csrc/layer_norm_bwd.cu`` (K4-bwd), the gradient of the above:
  dx (= dresidual), dscale and dbias in one launch and one pass over x,
  the residual and dy, the statistics recomputed, dscale and dbias
  reduced over the rows in a fixed order without float atomics (two
  calls give the same bits; ``bwd_row_plan`` and ``bwd_row_run`` say
  which rows each block takes). It takes float32,
  bfloat16 and float16 rows of any width (a width that is not whole
  16-byte vectors is zero-padded to them). JAX has no Pallas backward
  here: ``_ln_pallas_bwd`` takes the VJP of ``_ln_reference``. CUDA
  tensors only: it launches or raises.
- ``LayerNormFunction``: the autograd Function over the two kernels, the
  counterpart of the JAX ``_ln_pallas`` custom_vjp. Its backward is
  ``layer_norm_backward``: K4-bwd for CUDA tensors (other float dtypes,
  and a residual in another dtype than x, run it in f32 on x + residual,
  which is what the forward normalises), the plain backward for CPU
  tensors.
- ``_ln_reference`` and ``_ln_backward_reference``: the plain versions of
  the forward and of the backward (the closed form of the VJP that JAX
  takes).
- ``layer_norm``: CUDA tensors go to the kernels (through
  ``LayerNormFunction`` when a gradient is wanted), CPU tensors to the
  plain forward, which autograd differentiates. Unlike the JAX package,
  where the Pallas kernel is opt-in (``MMF_TPU_LN``), the port always
  takes its kernels on the card; whether it should is measured in
  ``PERF.md``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from mmf_tpu_torch.ops._build import BUILD_ROOT

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def _ln_backward_reference(x, residual, scale, bias, dy, eps):
    """Plain version of K4-bwd: (dx in x's dtype, dresidual in the
    residual's dtype or None, dscale, dbias in the parameters' dtypes),
    the closed form of the VJP of ``_ln_reference``."""
    hidden = x.shape[-1]
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = torch.square(h - mean).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (h - mean) * rstd
    d = dy.float()
    g = d * scale.float()
    dh = rstd * (g - g.mean(dim=-1, keepdim=True)
                 - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale = (d * xhat).reshape(-1, hidden).sum(dim=0)
    dbias = d.reshape(-1, hidden).sum(dim=0)
    return (dh.to(x.dtype),
            None if residual is None else dh.to(residual.dtype),
            dscale.to(scale.dtype), dbias.to(bias.dtype))


def _bwd_lib():
    from mmf_tpu_torch.ops._build import load_library

    lib, info = load_library("layer_norm_bwd", ["layer_norm_bwd.cu"])
    if not getattr(lib, "_mmf_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mmf_layer_norm_bwd.argtypes = [p] * 8 + [i] * 4 + [
            ctypes.c_float, i, i, p]
        lib.mmf_layer_norm_bwd.restype = i
        lib.mmf_layer_norm_bwd_geometry.argtypes = [
            i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.mmf_layer_norm_bwd_geometry.restype = i
        lib.mmf_cuda_error_string.argtypes = [i]
        lib.mmf_cuda_error_string.restype = ctypes.c_char_p
        lib._mmf_typed = True
    return lib, info


def build_layer_norm_bwd() -> dict:
    """Build (or reuse) K4-bwd's library; returns its build info."""
    return _bwd_lib()[1]


def _check_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: {lib.mmf_cuda_error_string(rc).decode()} "
            f"(cudaError {rc})"
        )


@functools.lru_cache(maxsize=None)
def _bwd_geometry(code: int, ld: int, index: int):
    """(SMs, blocks of K4-bwd's kernel one SM holds, rows a block takes at
    once) for rows of ``ld`` elements of dtype ``code`` on card ``index``.
    The query also lets the kernel take its shared memory on that card,
    which its launch needs."""
    lib, _ = _bwd_lib()
    per_sm, tile = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = lib.mmf_layer_norm_bwd_geometry(code, ld, ctypes.byref(per_sm),
                                             ctypes.byref(tile))
    _check_rc(lib, rc, "layer_norm_backward_kernel's occupancy query")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, max(per_sm.value, 1), tile.value


# the blocks whose partial column sums one block adds: the best of 4 to
# 132 at 132 blocks (12 within 0.3 us, one group of all 132 slower by 5-6
# us a call; NVIDIA H100 80GB HBM3, 700 W, PERF.md)
_GROUP = 16
# fewer rows than SMs take a block a tile, at most this many blocks (one
# group)
_FEW_BLOCKS = 16


@functools.lru_cache(maxsize=4096)
def bwd_row_plan(rows: int, sms: int, per_sm: int, tile: int):
    """K4-bwd's grid for ``rows`` rows on a card of ``sms`` SMs that hold
    ``per_sm`` of its blocks each, a block taking ``tile`` rows at once:
    ``(grid, group)``. A block a tile, but at least one an SM whenever
    rows >= sms and at most as many as the card holds at once (the
    blocks then walk their runs of rows, ``bwd_row_run``); below sms at
    most 16 blocks, one group. ``group``: the blocks whose partial column
    sums one block adds (up to 16; the groups' sums are then added in
    one more step)."""
    grid = -(-rows // tile)
    if rows >= sms:
        grid = max(grid, sms)
    else:
        grid = min(grid, _FEW_BLOCKS)
    grid = max(1, min(grid, sms * per_sm))
    return grid, min(grid, _GROUP)


def bwd_row_run(block: int, rows: int, grid: int):
    """(first row, rows) of K4-bwd's block ``block`` of ``grid``: one
    contiguous run of floor(rows / grid) or ceil(rows / grid) rows, as the
    kernel takes them."""
    q, rem = divmod(rows, grid)
    return block * q + min(block, rem), q + (block < rem)


_scratch = {}  # (card, stream) -> (partials f32, tickets int32)
_TICKET_STRIDE = 32  # the kernel's ticket counters sit 128 bytes apart


def _bwd_scratch(device, stream, floats, tickets):
    """K4-bwd's scratch on ``device`` for calls on ``stream``: partial
    column sums (f32, written before they are read) and the ticket
    counters (zero; each call leaves them zero). Calls on one stream run
    in order, so they share it; it grows, and is never cleared."""
    key = (device.index, stream)
    got = _scratch.get(key)
    if got is None or got[0].numel() < floats or got[1].numel() < tickets:
        old = (0, 0) if got is None else (got[0].numel(), got[1].numel())
        got = (torch.empty(max(floats, old[0]), dtype=torch.float32,
                           device=device),
               torch.zeros(max(tickets, old[1]), dtype=torch.int32,
                           device=device))
        _scratch[key] = got
    return got


def row_stride(hidden: int, dtype: torch.dtype) -> int:
    """The row length K4-bwd reads: ``hidden`` rounded up to whole
    16-byte vectors of ``dtype``."""
    per = 16 // dtype.itemsize
    return -(-hidden // per) * per


def _rows(t: torch.Tensor, hidden: int, ld: int) -> torch.Tensor:
    """``t`` as [rows, ld], contiguous with a 16-byte aligned start, the
    columns past ``hidden`` zero (``contiguous()`` would keep the offset
    of a view)."""
    t = t.reshape(-1, hidden)
    if ld != hidden:
        return torch.nn.functional.pad(t, (0, ld - hidden))
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def layer_norm_backward_kernel(
    x: torch.Tensor,
    scale: torch.Tensor,
    dy: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
):
    """K4-bwd on the card: ``(dx, dscale, dbias)`` of LayerNorm(x [+
    residual]) for the output gradient ``dy``. dx has x's shape and dtype
    and is also the residual's gradient; dscale and dbias are f32
    [hidden]. x, residual and dy of one shape and one dtype (float32,
    bfloat16 or float16), any hidden size; scale [hidden]. One kernel
    launch; inputs that are contiguous and 16-byte aligned at a width of
    whole 16-byte vectors are read in place."""
    for name, t in (("x", x), ("scale", scale), ("dy", dy),
                    ("residual", residual)):
        if t is not None and not t.is_cuda:
            raise RuntimeError(
                f"layer_norm_backward_kernel is a CUDA kernel: {name} is on "
                f"{t.device}. CPU tensors go through _ln_backward_reference "
                "(layer_norm_backward dispatches by device)."
            )
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or (residual is not None
                                      and residual.dtype != x.dtype):
        raise TypeError(
            f"layer_norm_backward_kernel takes float32, bfloat16 or float16, "
            f"the residual in x's dtype; got x {x.dtype}, residual "
            f"{None if residual is None else residual.dtype} "
            "(layer_norm_backward runs other dtypes in float32)"
        )
    hidden = x.shape[-1]
    for name, t in (("dy", dy), ("residual", residual)):
        if t is not None and t.shape != x.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match x "
                             f"{tuple(x.shape)}")
    if scale.shape != (hidden,):
        raise ValueError(f"scale must be [{hidden}], got {tuple(scale.shape)}")
    if x.numel() == 0:
        zero = torch.zeros(hidden, dtype=torch.float32, device=x.device)
        return torch.empty_like(x), zero, zero.clone()
    ld = row_stride(hidden, x.dtype)
    x2d = _rows(x, hidden, ld)
    r2d = None if residual is None else _rows(residual, hidden, ld)
    dy2d = _rows(dy.to(x.dtype), hidden, ld)
    w = _rows(scale.to(torch.float32), hidden, ld).view(ld)
    rows, code, index = x2d.shape[0], _DTYPE_CODE[x.dtype], x.device.index
    lib, _ = _bwd_lib()
    grid, group = bwd_row_plan(rows, *_bwd_geometry(code, ld, index))
    groups = -(-grid // group)
    dx = torch.empty_like(x2d)
    out = torch.empty((2, ld), dtype=torch.float32, device=x.device)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream().cuda_stream
        part, tickets = _bwd_scratch(x.device, stream,
                                     (grid + groups) * 2 * ld,
                                     (groups + 1) * _TICKET_STRIDE)
        rc = lib.mmf_layer_norm_bwd(
            x2d.data_ptr(), None if r2d is None else r2d.data_ptr(),
            w.data_ptr(), dy2d.data_ptr(), dx.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), out.data_ptr(), code, rows, hidden, ld,
            float(eps), grid, group, stream,
        )
    _check_rc(lib, rc, "layer_norm_backward_kernel launch")
    layer_norm_backward_kernel.launches += 1
    return dx[:, :hidden].view(x.shape), out[0, :hidden], out[1, :hidden]


layer_norm_backward_kernel.launches = 0


def kernel_operands(x, residual, dy):
    """(x, residual, dy) as K4-bwd reads them: unchanged where x is
    float32, bfloat16 or float16 and the residual (if any) in x's dtype;
    else h = x + residual in f32, no residual, and dy in f32, which is
    what the forward normalises and what its gradient is taken of."""
    if x.dtype in _DTYPE_CODE and (residual is None
                                   or residual.dtype == x.dtype):
        return x, residual, dy
    h = x.float() if residual is None else x.float() + residual.float()
    return h, None, dy.float()


def layer_norm_backward(x, residual, scale, bias, dy, eps):
    """(dx, dresidual or None, dscale, dbias) of LayerNorm(x [+ residual]):
    K4-bwd for CUDA tensors (its one dx tensor is the residual's gradient
    too where the dtypes agree), the plain backward for CPU tensors."""
    if not x.is_cuda:
        return _ln_backward_reference(x, residual, scale, bias, dy, eps)
    kx, kr, kdy = kernel_operands(x, residual, dy)
    dh, dscale, dbias = layer_norm_backward_kernel(kx, scale, kdy, kr, eps)
    return (dh.to(x.dtype), None if residual is None else dh.to(
        residual.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype))


class LayerNormFunction(torch.autograd.Function):
    """Forward: the Triton kernel. Backward: ``layer_norm_backward`` on the
    saved inputs (K4-bwd on the card), the statistics recomputed."""

    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps):
        ctx.save_for_backward(x, residual, scale, bias)
        ctx.eps = eps
        return layer_norm_kernel(x, scale, bias, residual, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, residual, scale, bias = ctx.saved_tensors
        grads = layer_norm_backward(x, residual, scale, bias, grad, ctx.eps)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


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
