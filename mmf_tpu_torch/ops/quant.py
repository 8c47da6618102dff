"""Dynamic int8 quantised matmul: the hand-written CUDA GEMM (K5) and its
plain PyTorch version.

Port of ``mmf_tpu/ops/quant.py``, the serving-precision path behind
``quant: int8`` (or ``MMF_TPU_QUANT=int8``):

- weights: symmetric per-output-channel int8, quantised from the live
  float32 parameters on every call (checkpoints, converters and
  optimizers never see int8);
- activations: symmetric per-row (per-token) dynamic int8;
- the product: int8 x int8 summed exactly in int32, dequantised with the
  outer product of the two scale vectors, bias and output-dtype cast in
  the same epilogue.

Pieces:

- ``quantize_rows`` / ``quantize_cols``: as in JAX (eps 1e-6 and 1e-11,
  clip to +-127, round half to even).
- ``dequant_gemm``: wrapper of the CUDA C++ kernel
  ``ops/csrc/int8_gemm.cu`` (K5), which replaces the Pallas kernel
  ``mmf_tpu/ops/quant.py::_dequant_gemm_kernel``. CUDA tensors only: it
  launches or raises, and counts its launches. Unlike the TPU kernel it
  takes any M and N (ragged edges are zero-filled by TMA and masked in
  the epilogue) and any K that is a multiple of 16 with K * 127^2 <
  2^31; other K raise. ``k5_tile`` picks the kernel's output tile from
  the shapes.
- ``dequant_gemm_reference``: the plain version. The int32 product is
  computed exactly through a float64 matmul (|sum| < 2^53), then the
  epilogue runs as JAX's XLA path does: ``y * (xs * ws) + bias``.
- ``Int8DenseFunction`` / ``int8_dense`` / ``int8_matmul``: the
  straight-through autograd Function (backward is the exact f32 matmul
  VJP, as JAX's custom_vjp) and its entry points. CUDA inputs run K5,
  CPU inputs the plain version. On the card a K that is not a multiple
  of 16 runs K5 on operands zero-padded to one (``pad_k``: the int32 sums
  are unchanged); a K above ``MAX_K`` raises, as K5 does.
- ``QuantDense``: ``Dense`` with the matmul routed through ``int8_dense``;
  the same parameter names and shapes (``weight`` [out, in] f32,
  ``bias`` [out] f32), so the knob never changes a ``state_dict`` key.

Layout: the port keeps weights as [N, K] (``F.linear``'s [out, in]).
Quantising each row of that weight gives the integers and scales that
JAX's ``quantize_cols`` gives on its [K, N] kernel, and the int8 weight
stays [N, K], K contiguous: the kernel's B operand as it is.

The v5e speed figures of the JAX module and its rule that the Pallas
kernel is opt-in and TPU-only do not carry over: on the card every
quantised projection launches K5.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import nn

# |sum_k x8 w8| <= K * 127^2 must stay below 2^31 for the int32 sum
MAX_K = (2 ** 31 - 1) // (127 * 127)
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K5's output tiles: 128 x 128 (two consumer warpgroups) where those
# alone give every SM a block, else 64 x 64 (one warpgroup)
K5_LARGE, K5_SMALL = 128, 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k5_tile(m: int, n: int, sms: int = 132) -> int:
    """K5's output tile (128 or 64 rows and columns) for an [m, n] output
    on a card with ``sms`` SMs: 128 x 128 tiles when there are at least
    as many of them as SMs, else 64 x 64 tiles, four times as many
    blocks."""
    return (K5_LARGE if _cdiv(m, K5_LARGE) * _cdiv(n, K5_LARGE) >= sms
            else K5_SMALL)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def quantize_rows(x: torch.Tensor, eps: float = 1e-6):
    """Symmetric per-row int8: ``(q [..., k] int8, scale [..., 1] f32)``."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    scale = torch.clamp(amax, min=eps) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_cols(w: torch.Tensor, eps: float = 1e-11):
    """Symmetric per-column (output-channel) int8 for a [k, n] weight:
    ``(q [k, n] int8, scale [1, n] f32)``."""
    q, scale = quantize_rows(w.t(), eps)
    return q.t(), scale.t()


def pad_k(x8: torch.Tensor, w8: torch.Tensor):
    """x8 [M, K] and w8 [N, K] with K zero-padded to a multiple of 16, the
    whole 16-byte vectors K5 reads: every product with a padded column is
    0, so the int32 sums are those of the unpadded operands."""
    pad = -x8.shape[-1] % 16
    if pad == 0:
        return x8, w8
    return (nn.functional.pad(x8, (0, pad)),
            nn.functional.pad(w8, (0, pad)))


def dequant_gemm_reference(x8, w8, xs, ws, bias, out_dtype):
    """Plain version of K5: x8 int8 [M, K], w8 int8 [N, K], xs f32 [M],
    ws f32 [N], bias f32 [N] or None -> [M, N] in ``out_dtype``."""
    y = torch.matmul(x8.double(), w8.double().t()).float()  # exact int sum
    y = y * (xs.float()[:, None] * ws.float()[None, :])
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.to(out_dtype)


def _lib():
    from mmf_tpu_torch.ops._build import load_library

    lib, info = load_library("int8_gemm", ["int8_gemm.cu"])
    if not getattr(lib, "_mmf_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mmf_int8_gemm.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.mmf_int8_gemm.restype = ctypes.c_int
        lib.mmf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mmf_cuda_error_string.restype = ctypes.c_char_p
        lib._mmf_typed = True
    return lib, info


def build_int8_gemm() -> dict:
    """Build (or reuse) K5's library; returns its build info."""
    return _lib()[1]


def dequant_gemm(x8: torch.Tensor, w8: torch.Tensor, xs: torch.Tensor,
                 ws: torch.Tensor, bias: Optional[torch.Tensor],
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K5 on the card: ``(x8 @ w8^T) * (xs ws^T) + bias`` cast to
    ``out_dtype`` (float32 or bfloat16). x8 int8 [M, K], w8 int8 [N, K],
    xs f32 [M], ws f32 [N], bias f32 [N] or None, all on one CUDA
    device."""
    if x8.dtype != torch.int8 or w8.dtype != torch.int8 or \
            x8.dim() != 2 or w8.dim() != 2:
        raise TypeError(
            f"x8 and w8 must be 2-D int8, got {x8.dtype} {tuple(x8.shape)} "
            f"and {w8.dtype} {tuple(w8.shape)}"
        )
    m, k = x8.shape
    n = w8.shape[0]
    if w8.shape[1] != k:
        raise ValueError(f"x8 {tuple(x8.shape)} and w8 {tuple(w8.shape)} "
                         "disagree on K")
    if k <= 0 or k % 16 != 0 or k > MAX_K:
        raise ValueError(
            f"dequant_gemm takes K a positive multiple of 16 up to {MAX_K} "
            f"(whole 16-byte vectors, an exact int32 sum), got K={k}"
        )
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    for name, t, size in (("xs", xs, m), ("ws", ws, n), ("bias", bias, n)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != size):
            raise ValueError(f"{name} must be float32 with {size} entries, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("x8", x8), ("w8", w8), ("xs", xs), ("ws", ws),
                    ("bias", bias)):
        if t is not None and not t.is_cuda:
            raise RuntimeError(
                f"dequant_gemm is a CUDA kernel: {name} is on {t.device}. "
                "CPU tensors go through dequant_gemm_reference (int8_dense "
                "dispatches by device)."
            )
        if t is not None and t.device != x8.device:
            raise ValueError(f"{name} is on {t.device}, x8 on {x8.device}")
    # fresh allocations are 16-byte aligned (contiguous() would keep the
    # offset of a view)
    x8, w8 = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
              else t.clone(memory_format=torch.contiguous_format)
              for t in (x8, w8))
    xs, ws = xs.reshape(m).contiguous(), ws.reshape(n).contiguous()
    if bias is not None:
        bias = bias.reshape(n).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x8.device)
    if out.numel() == 0:
        return out
    lib, _ = _lib()
    tile = k5_tile(m, n, _sm_count(x8.device.index))
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream(x8.device).cuda_stream
        rc = lib.mmf_int8_gemm(
            x8.data_ptr(), w8.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            _OUT_CODE[out_dtype], m, n, k, tile, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"dequant_gemm kernel launch failed: "
            f"{lib.mmf_cuda_error_string(rc).decode()} (cudaError {rc})"
        )
    dequant_gemm.launches += 1
    return out


dequant_gemm.launches = 0


def _int8_dense_forward(x, weight, bias, out_dtype):
    x8, xs = quantize_rows(x)
    # per output row of the [N, K] weight == JAX's quantize_cols on [K, N]
    w8, ws = quantize_rows(weight, eps=1e-11)
    lead, k, n = x.shape[:-1], x.shape[-1], weight.shape[0]
    x8 = x8.reshape(-1, k)
    args = (xs.reshape(-1), ws.reshape(-1), bias.float(), out_dtype)
    if x.is_cuda:
        y = dequant_gemm(*pad_k(x8, w8), *args)
    else:
        y = dequant_gemm_reference(x8, w8, *args)
    return y.reshape(*lead, n)


class Int8DenseFunction(torch.autograd.Function):
    """Forward: the int8 product (K5 on the card). Backward: the
    straight-through f32 matmul VJP of ``x @ weight^T + bias``, as JAX's
    ``_int8_dense_bwd``: gx = g W (cast to x's dtype), gW = g^T x and
    gb = sum g, in f32."""

    @staticmethod
    def forward(ctx, x, weight, bias, out_dtype):
        ctx.save_for_backward(x, weight)
        return _int8_dense_forward(x, weight, bias, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        n, k = weight.shape
        g32 = g.float().reshape(-1, n)
        gx = (g32 @ weight.float()).to(x.dtype).reshape(x.shape)
        gw = g32.t() @ x.reshape(-1, k).float()
        gb = g32.sum(dim=0)
        return gx, gw.to(weight.dtype), gb, None


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ weight^T [+ bias]`` on the int8 path, epilogue fused. x:
    [..., k] any float dtype; weight: [n, k] (``F.linear``'s layout);
    bias: [n] or None. Backward is the straight-through f32 matmul VJP."""
    if bias is None:
        bias = torch.zeros(weight.shape[0], dtype=torch.float32,
                           device=weight.device)
    return Int8DenseFunction.apply(x, weight, bias, out_dtype)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight^T`` on the int8 path; float32 result (no bias)."""
    return int8_dense(x, weight, None, torch.float32)


class QuantDense(nn.Linear):
    """The trunk's ``Dense`` with the matmul routed through
    ``int8_dense``. Parameters stay float32 (``weight`` [out, in],
    ``bias`` [out]) and are quantised on every call, so the weight is
    never cast to the compute dtype (that would move every scale); the
    output is in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self):
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return int8_dense(x, self.weight, self.bias, self.compute_dtype)
