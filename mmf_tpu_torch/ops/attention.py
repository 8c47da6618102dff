"""Multi-head attention: the hand-written CUDA flash kernel and its plain
PyTorch version.

Port of ``mmf_tpu/ops/attention.py``. Layout [B, H, S, D]; the bias is
additive and broadcastable to [B, H, Sq, Skv].

- ``flash_attention`` / ``flash_attention_with_stats``: wrappers of the
  CUDA C++ kernel ``ops/csrc/flash_attention_fwd.cu`` (K1), which
  replaces the Pallas kernel ``mmf_tpu/ops/attention.py::_flash_kernel``
  in its inference form and in its ``with_lse`` form (row max ``m`` and
  normalizer ``l`` for the backward); ``flash_attention_block`` wraps its
  ``raw_stats`` form (the unnormalized accumulator with raw ``m`` and
  ``l``), the block state that ring attention merges
  (``merge_block_states``, plain torch).
- ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv``: wrappers of
  ``ops/csrc/flash_attention_bwd.cu``, which replaces
  ``_flash_bwd_dq_kernel`` (K2) and ``_flash_bwd_dkv_kernel`` (K3).
  ``delta = rowsum(dO O)`` is folded into K2's prologue, which writes it
  for K3.
- ``FlashAttentionFunction``: the autograd Function over them, the
  counterpart of JAX's ``_flash_attention`` custom_vjp.
  The kernel sources say what bounds them on the H100 and how their
  design answers that. Every kernel wrapper takes CUDA tensors only: it
  launches or raises, and counts its launches.
- ``mha_reference``, ``flash_forward_reference``,
  ``flash_attention_block_reference`` and ``flash_backward_reference``:
  the plain versions, f32 scores and
  softmax. Unlike the JAX reference they do not store bf16 logits (that
  was a TPU bandwidth choice), and a row whose every score is -inf gives
  zeros (and zero gradients), as the kernels do, where the JAX functions
  give NaN.
- ``dot_product_attention``: CUDA tensors go to the kernels, CPU tensors
  to the plain version. Attention-probability dropout goes to the plain
  version on either device, as in JAX. A head dim that is not a
  multiple of 8 is zero-padded to one for the kernels (exact: the padded
  q and k columns add nothing to the scores, the padded output columns
  are cut off); head dims above 128 raise on the card. No
  sequence-length crossover: the TPU's ``PALLAS_MIN_SEQ`` numbers do not
  carry over.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Plain attention. q: [B,H,Sq,D], k/v: [B,H,Skv,D], bias additive
    and broadcastable to [B,H,Sq,Skv]. Scores, softmax and the p·v
    accumulation are f32; probabilities are rounded to v's dtype before
    the product, as in JAX. Dropout of the probabilities is active only
    when ``dropout_rate > 0`` and a ``generator`` is given."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(l == 0, torch.ones_like(l), l)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(
            probs.shape, generator=generator, device=probs.device
        ) < (1.0 - dropout_rate)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _scores(q, k, bias, scale):
    """f32 scores ``q k^T * scale + bias``, as the kernels compute them."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return s if bias is None else s + bias.float()


def flash_forward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """Plain version of the kernel's stats form: ``(out, m, l)`` with
    ``out`` as ``mha_reference`` gives it, and the row max ``m`` and
    normalizer ``l`` of the scores, f32 [B,H,Sq]. A row with ``l == 0``
    (every score -inf) stores ``m = 0`` and ``l = 1``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, scale)
    m = s.amax(dim=-1)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    empty = l == 0
    return (mha_reference(q, k, v, bias, scale),
            torch.where(empty, torch.zeros_like(m), m),
            torch.where(empty, torch.ones_like(l), l))


def flash_attention_block_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """Plain version of the kernel's raw-stats form: ``(acc, m, l)`` with
    the raw row max ``m`` of the scores, ``l = sum_k exp(s - m)`` and the
    UNNORMALIZED ``acc = exp(s - m) v``, all f32 (acc [B,H,Sq,D], m and l
    [B,H,Sq]); probabilities are rounded to v's dtype before the product,
    as in ``mha_reference``. A row with no finite score gives m = -inf,
    l = 0, acc = 0 (JAX gives NaN there)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, scale)
    m = s.amax(dim=-1)
    m_use = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_use[..., None])
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(dim=-1)


def merge_block_states(states):
    """Merge ``(acc, m, l)`` block states over disjoint kv blocks with the
    ring recurrence of ``mmf_tpu/ops/ring_attention.py``: m' = max(m1,
    m2), acc' = acc1 e^(m1 - m') + acc2 e^(m2 - m'), l' likewise. A state
    with m = -inf is empty and adds nothing. The attention output is
    ``acc' / l'`` (zero where l' = 0)."""
    acc, m, l = states[0]
    for acc_b, m_b, l_b in states[1:]:
        m_new = torch.maximum(m, m_b)
        m_use = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                            m_new)
        alpha, beta = torch.exp(m - m_use), torch.exp(m_b - m_use)
        acc = acc * alpha[..., None] + acc_b * beta[..., None]
        l = l * alpha + l_b * beta
        m = m_new
    return acc, m, l


def flash_backward_reference(q, k, v, bias, out, m, l, dout, scale=None):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` in the
    input dtypes from the forward's ``out``, ``m`` and ``l``, by the
    formulas of the kernels in f32: p = exp(s - m) / l, delta =
    rowsum(dO O), ds = p (dO v^T - delta), dq = scale ds k, dk = scale
    ds^T q, dv = p^T dO."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.exp(_scores(q, k, bias, scale) - m[..., None]) / l[..., None]
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, v.float().transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _typed_library(name: str, functions) -> tuple:
    """Build (or reuse) ``name`` from ``ops/csrc/<name>.cu`` and set the
    ctypes signatures: ``functions`` maps each entry point to its
    argument types (every entry point returns a cudaError_t as int)."""
    from mmf_tpu_torch.ops._build import load_library

    lib, info = load_library(name, [f"{name}.cu"])
    if not getattr(lib, "_mmf_typed", False):
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mmf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mmf_cuda_error_string.restype = ctypes.c_char_p
        lib._mmf_typed = True
    return lib, info


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_DIMS = [_I] * 6  # dtype, B, H, Sq, Skv, D


def _fwd_lib():
    return _typed_library("flash_attention_fwd", {
        "mmf_flash_attention_fwd":
            [_P] * 7 + _DIMS + [_STRIDES, _F, _P],
        "mmf_flash_attention_fwd_raw":
            [_P] * 7 + _DIMS + [_STRIDES, _F, _P],
        "mmf_flash_attention_fwd_smem_bytes": [_I, _I],
        "mmf_flash_attention_fwd_occupancy": [_I, _I, _I, _P],
    })


def _bwd_lib():
    return _typed_library("flash_attention_bwd", {
        "mmf_flash_attention_bwd_dq": [_P] * 10 + _DIMS + [_STRIDES, _F, _P],
        "mmf_flash_attention_bwd_dkv": [_P] * 10 + _DIMS + [_STRIDES, _F, _P],
        "mmf_flash_attention_bwd_smem_bytes": [_I, _I, _I],
        "mmf_flash_attention_bwd_dq_occupancy": [_I, _I, _P],
    })


def _kernel_layout_ok(t: torch.Tensor, tma: bool) -> bool:
    """Contiguous head dim; for a kernel that loads ``t`` by TMA (``tma``:
    every attention kernel, in both dtypes) also 16-byte aligned rows and
    positive strides on dims longer than 1 (TMA maps cannot
    broadcast)."""
    if t.stride(-1) != 1:
        return False
    if not tma:
        return True
    per16 = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s % per16 == 0 and (s > 0 or n == 1)
        for s, n in zip(t.stride()[:3], t.shape[:3]))


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the attention kernels take it (loaded by TMA). A fresh
    allocation is aligned (contiguous() would keep an offset view)."""
    if _kernel_layout_ok(t, tma=True):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_qkv(what: str, q, k, v):
    """Device, dtype and shape checks shared by the kernel wrappers;
    returns (B, H, Sq, Skv, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise RuntimeError(
                f"{what} is a CUDA kernel: {name} is on {t.device}. CPU "
                "tensors go through the plain versions "
                "(dot_product_attention dispatches by device)."
            )
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B,H,S,D], got {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{what} takes q/k/v all float32 or all bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if d % 8 != 0 or d > 128:
        raise ValueError(f"head dim {d} must be a multiple of 8 up to 128")
    return b, h, sq, skv, d


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at: ``d`` rounded up
    to a multiple of 8. The kernels take up to 128."""
    if not 0 < d <= 128:
        raise ValueError(f"the attention kernels take head dims 1 to 128, "
                         f"got {d}")
    return -(-d // 8) * 8


def pad_head_dim(*tensors):
    """The [..., D] tensors zero-padded to ``padded_head_dim(D)`` (the
    tensors themselves where D is a multiple of 8)."""
    pad = padded_head_dim(tensors[0].shape[-1]) - tensors[0].shape[-1]
    if pad == 0:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in tensors)


def _kernel_bias(bias, q, b, h, sq, skv):
    """(pointer or None, (batch, head, seq) strides, the f32 tensor that
    owns the pointer): the bias read in f32 with stride 0 on broadcast
    dims."""
    if bias is None:
        return None, (0, 0, 0), None
    if bias.device != q.device:
        raise ValueError(f"bias is on {bias.device}, q on {q.device}")
    if bias.dim() != 4 or bias.shape[-1] != skv:
        raise ValueError(
            f"bias must be [B|1,H|1,Sq|1,{skv}], got {tuple(bias.shape)}"
        )
    bias = bias.to(torch.float32).expand(b, h, sq, skv)
    if bias.stride(-1) != 1:
        bias = bias.contiguous()
    return bias.data_ptr(), bias.stride()[:3], bias


def _bshd_empty(b, h, s, d, like):
    """[B,H,S,D] output laid out as [B,S,H,D] in memory: the layout the
    next projection reads, and the one autograd hands back to the
    [B,S,H,D] -> [B,H,S,D] view of a projection."""
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _check_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.mmf_cuda_error_string(rc).decode()} (cudaError {rc})"
        )


def _strides(*tensors_or_triples):
    vals = []
    for t in tensors_or_triples:
        vals.extend(t.stride()[:3] if isinstance(t, torch.Tensor) else t)
    return (ctypes.c_longlong * len(vals))(*vals)


def build_flash_attention() -> dict:
    """Build (or reuse) the forward kernel library; returns its build
    info."""
    return _fwd_lib()[1]


def build_flash_attention_bwd() -> dict:
    """Build (or reuse) the backward kernels' library; returns its build
    info."""
    return _bwd_lib()[1]


def _flash_forward(q, k, v, bias, scale, with_stats):
    what = "flash_attention_with_stats" if with_stats else "flash_attention"
    b, h, sq, skv, d = _check_qkv(what, q, k, v)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    if scale is None:
        scale = d ** -0.5
    bias_ptr, bias_strides, _bias = _kernel_bias(bias, q, b, h, sq, skv)
    out = _bshd_empty(b, h, sq, d, q)
    m = l = None
    if with_stats:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l  # nothing to launch
    lib, _ = _fwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mmf_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(), _DTYPE_CODE[q.dtype],
            b, h, sq, skv, d, _strides(q, k, v, out, bias_strides),
            float(scale), stream,
        )
    _check_rc(lib, rc, what)
    return out, m, l


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-attention forward on the card, inference form (no stats).
    q: [B,H,Sq,D], k/v: [B,H,Skv,D], all float32 or all bfloat16, D a
    multiple of 8 up to 128, last dim contiguous (other strides are
    free). bias: any float dtype, broadcastable to [B,H,Sq,Skv]; it is
    read in f32 with stride 0 on broadcast dims. Returns [B,H,Sq,D] in
    q's dtype, laid out as [B,Sq,H,D] in memory."""
    out, _, _ = _flash_forward(q, k, v, bias, scale, with_stats=False)
    flash_attention.launches += out.numel() > 0
    return out


flash_attention.launches = 0


def flash_attention_with_stats(q, k, v, bias=None, scale=None):
    """The kernel's stats form (the TPU kernel's ``with_lse``): ``(out,
    m, l)`` with the row max and normalizer of the scores, f32 [B,H,Sq],
    for the backward kernels. Arguments as ``flash_attention``."""
    out, m, l = _flash_forward(q, k, v, bias, scale, with_stats=True)
    flash_attention_with_stats.launches += out.numel() > 0
    return out, m, l


flash_attention_with_stats.launches = 0


def flash_attention_block(q, k, v, bias=None, scale=None):
    """The kernel's raw-stats form (the TPU kernel's ``raw_stats``, the
    block state of ring attention): ``(acc, m, l)`` as
    ``flash_attention_block_reference`` gives them, acc f32 [B,H,Sq,D]
    (contiguous), m and l f32 [B,H,Sq]. Arguments as ``flash_attention``.
    Merge the states of several kv blocks with ``merge_block_states``."""
    b, h, sq, skv, d = _check_qkv("flash_attention_block", q, k, v)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    if scale is None:
        scale = d ** -0.5
    bias_ptr, bias_strides, _bias = _kernel_bias(bias, q, b, h, sq, skv)
    acc = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if acc.numel() == 0:
        return acc, m, l
    lib, _ = _fwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mmf_flash_attention_fwd_raw(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), _DTYPE_CODE[q.dtype],
            b, h, sq, skv, d, _strides(q, k, v, acc, bias_strides),
            float(scale), stream,
        )
    _check_rc(lib, rc, "flash_attention_block")
    flash_attention_block.launches += 1
    return acc, m, l


flash_attention_block.launches = 0


def _check_backward_args(what, q, k, v, stats, grads):
    b, h, sq, skv, d = _check_qkv(what, q, k, v)
    for name, t in stats.items():
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or \
                t.device != q.device:
            raise ValueError(
                f"{name} must be float32 [{b},{h},{sq}] on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    for name, t in grads.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must be {q.dtype} {tuple(q.shape)} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    return b, h, sq, skv, d


def flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout, scale=None):
    """K2 on the card: ``(dq, delta)``. ``out``, ``m``, ``l`` come from
    ``flash_attention_with_stats``; ``dout`` is the gradient of ``out``.
    The kernel also writes ``delta = rowsum(dout * out)``, f32 [B,H,Sq],
    which ``flash_attention_bwd_dkv`` reads. dq is [B,H,Sq,D] in q's
    dtype, laid out as [B,Sq,H,D]."""
    b, h, sq, skv, d = _check_backward_args(
        "flash_attention_bwd_dq", q, k, v, {"m": m, "l": l},
        {"out": out, "dout": dout})
    q, k, v, out, dout = (_kernel_operand(t) for t in (q, k, v, out, dout))
    m, l = m.contiguous(), l.contiguous()
    if scale is None:
        scale = d ** -0.5
    bias_ptr, bias_strides, _bias = _kernel_bias(bias, q, b, h, sq, skv)
    dq = _bshd_empty(b, h, sq, d, q)
    delta = torch.empty_like(m)
    if dq.numel() == 0:
        return dq, delta
    zero = (0, 0, 0)
    lib, _ = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mmf_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), bias_ptr, m.data_ptr(), l.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _DTYPE_CODE[q.dtype],
            b, h, sq, skv, d,
            _strides(q, k, v, out, dout, dq, zero, zero, bias_strides),
            float(scale), stream,
        )
    _check_rc(lib, rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta, scale=None):
    """K3 on the card: ``(dk, dv)`` from the forward's ``m``, ``l`` and
    the ``delta`` that ``flash_attention_bwd_dq`` wrote. dk/dv are
    [B,H,Skv,D] in k's dtype, laid out as [B,Skv,H,D]."""
    b, h, sq, skv, d = _check_backward_args(
        "flash_attention_bwd_dkv", q, k, v,
        {"m": m, "l": l, "delta": delta}, {"dout": dout})
    q, k, v, dout = (_kernel_operand(t) for t in (q, k, v, dout))
    m, l, delta = m.contiguous(), l.contiguous(), delta.contiguous()
    if scale is None:
        scale = d ** -0.5
    bias_ptr, bias_strides, _bias = _kernel_bias(bias, q, b, h, sq, skv)
    dk = _bshd_empty(b, h, skv, d, k)
    dv = _bshd_empty(b, h, skv, d, v)
    if dk.numel() == 0:
        return dk, dv
    zero = (0, 0, 0)
    lib, _ = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mmf_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            bias_ptr, m.data_ptr(), l.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype],
            b, h, sq, skv, d,
            _strides(q, k, v, zero, dout, zero, dk, dv, bias_strides),
            float(scale), stream,
        )
    _check_rc(lib, rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Counterpart of the JAX ``_flash_attention`` custom_vjp: the
    forward runs the kernel's stats form and saves (q, k, v, bias, out,
    m, l); the backward runs K2 then K3. The bias is a mask: it gets no
    gradient (JAX returns zeros for it)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, m, l = flash_attention_with_stats(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out, m, l)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, m, l = ctx.saved_tensors
        dq, delta = flash_attention_bwd_dq(q, k, v, bias, out, m, l, dout,
                                           ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta,
                                         ctx.scale)
        return dq, dk, dv, None, None


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Framework-wide attention entry point, [B,H,S,D] layout. CUDA
    tensors run the kernels: the stats form forward with K2/K3 as its
    backward when a gradient is wanted, the inference form otherwise.
    CPU tensors and active dropout run ``mha_reference`` (autograd
    differentiates it). On the card a head dim that is not a multiple of
    8 runs zero-padded (``pad_head_dim``) with the scale of the true head
    dim, and the output is cut back to it."""
    if dropout_rate > 0.0 and generator is not None:
        return mha_reference(q, k, v, bias, scale, dropout_rate, generator)
    if not q.is_cuda:
        return mha_reference(q, k, v, bias, scale)
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    q, k, v = pad_head_dim(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttentionFunction.apply(q, k, v, bias, scale)
    else:
        out = flash_attention(q, k, v, bias, scale)
    return out if out.shape[-1] == d else out[..., :d]


def make_attention_bias(mask: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, Skv] {0,1} padding mask -> additive bias [B, 1, 1, Skv] with
    the finite ``DEFAULT_MASK_VALUE`` at masked columns."""
    bias = (1.0 - mask.float()) * DEFAULT_MASK_VALUE
    return bias[:, None, None, :].to(dtype)


def combine_biases(*biases) -> Optional[torch.Tensor]:
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    return out
