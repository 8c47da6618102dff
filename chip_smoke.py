"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line starting with "phase"; any failure raises and
the script exits non-zero without a result line):

1. build    - the card's name and power limit, torch's version, and the
              build of every kernel on the serving and training paths
              from this checkout's sources, all started together: nvcc
              for the CUDA flash-attention forward (K1) and backward (K2,
              K3), the int8 GEMM (K5) and the LayerNorm backward
              (K4-bwd), Triton's JIT for the LayerNorm (K4), with build
              times, and the registers and spills of the wgmma kernels
              (K1, K2, K3, K5, with their shared memory) and of K4-bwd's,
              and ptxas's C75xx notes (a serialised wgmma shows there).
2. kernels  - each kernel against its plain PyTorch version on the card
              at the main paths' shapes, with stated tolerances, and both
              timed (best of several runs): K1 in its inference, stats
              and raw-stats forms (the raw states of the two kv halves
              merged against K1 over the whole kv), K2 and K3 (also
              against autograd through mha_reference; two calls
              bit-equal; B=64 S=228, B=8 Sq=128 Skv=100 and a long-kv
              case B=8 S=1024), all five by device_ms with CUDA events
              over back-to-back calls beside them, and the wrappers' host
              time per call; K4 in its four forms (bf16, f32, with and
              without the residual) at [14592, 768] and bf16 at bucket
              32's [7296, 768], and K4-bwd in the four forms at [14592,
              768] (two calls bit-equal), by device_ms over input sets
              rotated so that every call reads device memory, with the
              wrappers' host time; and K5 at the MMBT trunk's and
              pooler's shapes (M = 131 and 1) and VisualBERT's bucket 32
              (M = 7296), by device_ms, with its wrapper's host time.
              F.scaled_dot_product_attention (forward, forward with the
              rows' logsumexp, backward; by device_ms), F.layer_norm
              (forward and backward, by device_ms) and torch._int_mm are
              timed beside them for information; each
              kernel's bound (bytes over the memory rate, operations over
              the peak rate) is computed from its shapes.
3. serving  - VisualBERT-base at full width (12 x 768, 12 heads, 3129
              answers, bf16 compute; weights from a seeded
              torch.Generator) behind ServingEngine(max_batch_size=32) and
              ServingServer on 127.0.0.1, port 0. Concurrent /v1/predict
              requests in the VQA2 example layout; answers checked for
              status, shape and finiteness; the kernels' launch counts
              checked against the model's structure; one request's scores
              checked against the same weights' f32 forward on the CPU
              (plain versions); samples/s at bucket 32, request latency,
              and the bucket-32 forward's time (CUDA events) and device
              time by kind of kernel (torch.profiler).
4. training - VisualBERT-base at full width (f32 parameters, bf16
              compute, hidden dropout 0.1 from the step's generator,
              attention-probability dropout 0) trained with the VQA2
              config (AdamW lr 5e-5, BERT no-decay groups, warmup_cosine
              with its warmup cut to 2 updates, logit_bce) on B=64 VQA2
              batches: 1 warm-up and 6 timed steps, finite losses, exact
              launch counts per step (K4-bwd included), ms per step,
              samples/s, peak memory and device time by kind of kernel;
              then 3 steps through the kernels against
              3 steps through the plain versions from the same weights and
              batch at dropout 0, with each side's launches counted (the
              losses, the last after an update at lr > 0; per-parameter
              first-step gradient cosine and norm-relative error; update
              cosine; all against stated bounds).
5. mmbt     - MMBT-grid at full width (ResNet-152 at 224 px, 12 x 768,
              12 heads, 2 labels, bf16 compute, seeded weights) served at
              batch 1 through ServingEngine(max_batch_size=1) in bf16, with
              quant: int8 from the config, and with MMF_TPU_QUANT=int8 (the
              route mmf_serve takes): exact launch counts per forward,
              latency p50 and p95 over 50 calls (host clock, outputs on
              the host), device time per forward by kind of kernel; pooled
              features and scores against the f32 CPU forward (bf16) and
              the int8 CPU forward through the plain versions (int8), and
              the ResNet features under cuDNN's TF32 default against f32.
6. vb-int8  - the serving phase's VisualBERT-base with quant: int8 at
              bucket 32: K5 launches per forward, forward time beside
              bf16's, and one sample against the int8 CPU forward; K5 at
              every shape the forward launches it at (recorded from a
              forward), against its plain version, by device_ms beside
              torch._int_mm, with launches per shape and the K5 total per
              forward.

Then one JSON line describing the kernels, the nvidia-smi line, and the
last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import contextlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this run "
             "needs an NVIDIA card")

import torch.nn.functional as F  # noqa: E402

from mmf_tpu_torch.modules import transformer as T  # noqa: E402
from mmf_tpu_torch.ops import attention as A  # noqa: E402
from mmf_tpu_torch.ops import layernorm as L  # noqa: E402
from mmf_tpu_torch.ops import quant as Q  # noqa: E402
from mmf_tpu_torch.serving import ServingEngine  # noqa: E402
from mmf_tpu_torch.serving import engine as engine_lib  # noqa: E402
from mmf_tpu_torch.serving.server import ServingServer  # noqa: E402
from mmf_tpu_torch.trainers.core import train_state  # noqa: E402
from mmf_tpu_torch.utils import flagship  # noqa: E402

DEV = torch.device("cuda")
SEQ, REGIONS, VDIM, HEADS, HEAD_DIM, HIDDEN = 128, 100, 2048, 12, 64, 768
S = SEQ + REGIONS  # 228 tokens per sample
# f32: same algorithm, other summation order; bf16: outputs rounded to
# bf16, one ulp is 2^-8 relative
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
# served bf16 scores vs the f32 CPU forward on the same weights: twelve
# layers of bf16 activations; random-init scores have |s| ~ 0.5-2
SERVE_ATOL = 0.1
SERVE_MIN_COSINE = 0.999
N_REQUESTS = 8
# backward kernels: max abs error over the largest entry of the plain
# version's gradient. f32: same formulas, other summation order (TF32 off);
# bf16: p and ds rounded to bf16 before the tensor-core products and the
# gradients stored in bf16 (one ulp is 2^-8 relative). Against autograd
# through mha_reference (other formulas, other roundings) half as much
# again
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# stats form: m and l are f32 sums of the same products in another order
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
# raw-stats form's f32 accumulator, relative to its largest entry: f32 the
# same products in another order; bf16 probabilities rounded to bf16 at
# each tile's running max (the plain version rounds them at the final max)
RAW_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LONG_S = 1024  # the long-kv case: B=8, Sq = Skv = 1024
# K4-bwd against its plain backward, relative to the largest entry: dx in
# f32 the same formulas in other summation orders, in bf16 rounded to bf16
# (one ulp is 2^-8 relative); dscale and dbias are f32 sums of the same
# f32 products in both dtypes
LN_DX_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LN_PARAM_REL = 1e-5
# LayerNorm timings rotate over input sets that together hold at least
# this many bytes of what a call reads (L2 holds 50 MB), cut from a pool
# of LN_POOL [14592, 768] tensors each of x, residual and dy
ROTATE_BYTES = 150e6
LN_POOL = 7
SERVE_B = 32  # the serving phase's bucket
TRAIN_B, TRAIN_STEPS = 64, 6
# training step through the kernels vs through the plain versions, same
# weights and batch, dropout 0, bf16 compute: both round activations to
# bf16 at the same places; the kernels also round p and ds to bf16
TRAIN_LOSS_RTOL = 2e-3
TRAIN_MIN_GRAD_COSINE = 0.99
# per parameter: a missing or doubled scale in a backward kernel moves it
# to ~1 or beyond
TRAIN_MAX_GRAD_REL = 0.05
TRAIN_MIN_UPDATE_COSINE = 0.9
# steps of the kernel-vs-plain comparison: warmup_cosine runs update 0 at
# lr 0, so the third loss is the first one after a real update
COMPARED_STEPS = 3
# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the peak rate of
# the unit that runs them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
# K5 (int8 GEMM) shapes (M, K, N) on the main paths, with their launches
# per forward: the MMBT trunk at batch 1 (131 tokens; Q, K, V, O, FFN in,
# FFN out in 12 layers), its pooler (M = 1) and VisualBERT at bucket 32
# (32 x 228 tokens)
K5_MMBT = {(131, 768, 768): 48, (131, 768, 3072): 12, (131, 3072, 768): 12,
           (1, 768, 768): 1}
K5_VB = (7296, 768, 3072)
K5_HEADLINE = (131, 768, 3072)  # the row reported in the kernels line
# MMBT-grid at batch 1: 3 modal tokens (start, one pooled ResNet cell,
# end) and 128 text tokens; per forward 12 attention calls, 26 LayerNorms
# (24 residual, the embedding LayerNorm on the modal and the text span)
# and under int8 73 K5 launches (72 trunk projections and the pooler)
MMBT_PER_FORWARD = {"flash_attention_fwd": 12, "layer_norm": 26}
MMBT_K5 = 73
# VisualBERT under int8: its visual projection, 72 trunk projections, the
# pooler and the head transform (the answer logits stay a plain Dense)
VB_K5 = 75
LATENCY_CALLS = 50
# served outputs against a CPU forward of the same weights (plain
# versions): max abs error of scores and pooled features (|f| <= 1, tanh),
# and the pooled features' cosine. bf16 vs f32: twelve layers of bf16
# activations and TF32 convolutions. int8 vs int8: the same quantisation;
# bf16 and TF32 roundings that differ between card and CPU may flip a
# rounding at a .5 boundary, moving an activation by one step (1/127 of
# its row's largest entry)
MMBT_ATOL = 0.1
MMBT_MIN_COSINE = 0.999
# ResNet-152 features under cuDNN's TF32 default against f32 on the CPU,
# relative to the largest feature: a 10-bit mantissa in each of 155
# convolutions
MMBT_TF32_REL = 0.05


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, repeats=5) -> float:
    """Best of ``repeats`` runs of ``iters`` launches, CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def host_us(fn, iters=50) -> float:
    """Host time per call in microseconds: the wrapper's checks, ctypes
    call and launch (the backward's TMA descriptors included), without
    waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return us


def device_ms(fn, iters=20, repeats=5) -> float:
    """Device time per call, without the host's cost of launching it:
    a spin kernel (torch.cuda._sleep) holds the stream while ``iters``
    calls are queued behind it, so the CUDA events around the calls see
    them back to back. The spin is lengthened until it outlasts the
    queueing. Best of ``repeats``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 6)
    end.record()
    end.synchronize()
    cycles_per_ms = 1e6 / start.elapsed_time(end)
    spin_ms, best, done = 1.0, float("inf"), 0
    for _ in range(repeats + 10):
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if queued_ms > 0.5 * spin_ms:  # the spin may have ended first
            spin_ms = 4.0 * queued_ms
            continue
        best = min(best, start.elapsed_time(end) / iters)
        done += 1
        if done == repeats:
            return best
    raise RuntimeError("device_ms: the spin never outlasted the queueing")


def check(ok, what):
    """A failed check ends the run (an assert would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_err(got, want, dtype) -> float:
    torch.testing.assert_close(got, want, **TOL[dtype])
    return float((got.float() - want.float()).abs().max())


KERNELS = {  # name in the report -> the wrapper that counts launches
    "flash_attention_fwd": A.flash_attention,
    "flash_attention_fwd_stats": A.flash_attention_with_stats,
    "flash_attention_fwd_raw": A.flash_attention_block,
    "flash_attention_bwd_dq": A.flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": A.flash_attention_bwd_dkv,
    "layer_norm": L.layer_norm_kernel,
    "layer_norm_bwd": L.layer_norm_backward_kernel,
    "int8_dequant_gemm": Q.dequant_gemm,
}
ZERO_COUNTS = {name: 0 for name in KERNELS}


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def _short_name(mangled):
    """A kernel's short name with its template arguments, e.g.
    ``flash_fwd_sm90_kernel<1,0,3>`` or ``int8_gemm_sm90_kernel<1,64,4,4,
    bf16,3>``."""
    short = re.search(r"\d((?:bwd_d|flash_fwd_|int8_|ln_bwd)\w*?_kernel)"
                      r"(?:(I.*?E)?Ev|E)", mangled)
    if short is None:
        return mangled[-40:]
    kinds = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    args = [kinds.get(t, n)
            for n, t in re.findall(r"Li(\d+)E|(13__nv_bfloat16|6__half|f)",
                                   short.group(2) or "")]
    return short.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(log):
    """[(kernel, registers, spill store bytes, static smem bytes)] from
    nvcc's -Xptxas -v output, kernels demangled to their short names."""
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            name = _short_name(m.group(1))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and name is not None:
            out.append((name, int(m.group(1)), spill, int(m.group(2) or 0)))
            name = None
    return out


# -- phase 1 ---------------------------------------------------------------
def _ln_build():
    x = torch.zeros(2, HIDDEN, device=DEV, dtype=torch.bfloat16)
    w = torch.ones(HIDDEN, device=DEV)
    for residual in (None, x):  # both specialisations of the kernel
        for dtype in (torch.bfloat16, torch.float32):
            L.layer_norm_kernel(x.to(dtype), w, w * 0,
                                None if residual is None
                                else residual.to(dtype))
    torch.cuda.synchronize()


def phase_build(card):
    """Every kernel's build, started together: one nvcc per CUDA source
    and Triton's JIT, each in its own thread."""
    jobs = {"flash_attention_fwd": A.build_flash_attention,
            "flash_attention_bwd": A.build_flash_attention_bwd,
            "int8_gemm": Q.build_int8_gemm,
            "layer_norm_bwd": L.build_layer_norm_bwd,
            "layer_norm": _ln_build}
    done, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            done[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=item)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    parts, reports = [], {}
    for name in ("flash_attention_fwd", "flash_attention_bwd", "int8_gemm",
                 "layer_norm_bwd"):
        info, _ = done[name]
        kernels = ptxas_report(info["ptxas"])
        notes = re.findall(r"\((C75\d\d)\)", info["ptxas"])
        parts.append(f"{name} nvcc {info['build_s']:.1f}s ({len(kernels)} "
                     f"kernels, {sum(k[2] > 0 for k in kernels)} with "
                     "spills; ptxas notes " + (", ".join(
                         f"{c} x{notes.count(c)}" for c in sorted(set(
                             notes))) or "none") + ")")
        reports[name] = [k for k in kernels
                         if "sm90" in k[0] or "ln_bwd" in k[0]]
    smem = (A._fwd_lib()[0].mmf_flash_attention_fwd_smem_bytes(HEAD_DIM),
            A._bwd_lib()[0].mmf_flash_attention_bwd_smem_bytes(HEAD_DIM))
    parts.append(f"layer_norm triton jit {done['layer_norm'][1]:.1f}s")
    print(f"phase build: ok card='{card}' torch={torch.__version__} "
          f"cuda={torch.version.cuda}; built in parallel in {wall:.1f}s: "
          + "; ".join(parts))
    print("  wgmma kernels and K4-bwd's (ptxas: registers, spill store "
          "bytes; C7510, C7515 and C7520 would mean serialised products; "
          f"bf16 K1 takes {smem[0]} B of dynamic smem a block at "
          f"D={HEAD_DIM}, K2 and K3 {smem[1]} B; K4-bwd's template "
          "arguments: dtype, 16-byte vectors a lane, warps a row):")
    for name, kernels in reports.items():
        print(f"    {name}: " + "; ".join(
            f"{n} {r} regs, {sp} B spills" for n, r, sp, _ in kernels))


# -- phase 2 ---------------------------------------------------------------
def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the least time for the work on the card."""
    mem_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    op_ms = 1e3 * flops / PEAK_FLOPS[dtype]
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def rel_err(got, want, rel, what):
    """Max abs error, checked against ``rel`` times the largest entry."""
    want = want.float()
    err = float((got.float() - want).abs().max())
    scale = max(float(want.abs().max()), 1e-6)
    check(not torch.isnan(got).any() and err <= rel * scale,
          f"{what}: max abs err {err} > {rel} * {scale}")
    return err


def _attention_inputs(b, sq, skv, dtype, g):
    # q/k/v/dO as the [B,S,H,D] -> [B,H,S,D] views the attention block
    # hands the kernels; a padding mask with masked columns in every row
    def proj(s):
        return torch.randn(b, s, HEADS, HEAD_DIM, device=DEV,
                           generator=g).to(dtype).transpose(1, 2)

    mask = (torch.rand(b, skv, device=DEV, generator=g) > 0.2).int()
    mask[:, 0] = 1
    return (proj(sq), proj(skv), proj(skv), A.make_attention_bias(mask, dtype),
            proj(sq))


def _sdpa_with_lse(q, k, v, bias):
    """A callable: the memory-efficient SDPA forward that also returns the
    rows' logsumexp (m + log l), as SDPA calls it when a backward will
    follow. The bias is padded to an aligned row and broadcast by
    stride, as SDPA's own dispatch does."""
    skv = bias.shape[-1]
    padded = F.pad(bias, (0, -skv % 16))[..., :skv]
    padded = padded.expand(q.shape[0], q.shape[1], q.shape[2], skv)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, padded, True)


def _sdpa_backward(q, k, v, bias, dout):
    """One SDPA forward, and a callable timing its backward alone."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def phase_kernels(card):
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity
    g = torch.Generator(device=DEV).manual_seed(0)
    names = ("flash_attention_fwd", "flash_attention_fwd_stats",
             "flash_attention_fwd_raw", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    results = {n: {"err": 0.0} for n in names}
    lines = []
    cases = [(b, S, S, dt) for b in (1, 64)
             for dt in (torch.bfloat16, torch.float32)]
    cases.append((8, 128, 100, torch.bfloat16))  # Sq != Skv
    # long kv: many ring tiles and many 64-row blocks per (b, h)
    cases.append((8, LONG_S, LONG_S, torch.bfloat16))
    for b, sq, skv, dt in cases:
        q, k, v, bias, dout = _attention_inputs(b, sq, skv, dt, g)
        out = A.flash_attention(q, k, v, bias)
        out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
        raw = A.flash_attention_block(q, k, v, bias)
        half = skv // 2
        halves = [A.flash_attention_block(q, k[:, :, sl], v[:, :, sl],
                                          bias[..., sl])
                  for sl in (slice(0, half), slice(half, skv))]
        dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l,
                                             dout)
        dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
        torch.cuda.synchronize()
        ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
        err = max_err(out, ref_out, dt)
        check(torch.equal(out, out_s), "stats form output != inference form")
        torch.testing.assert_close(m, ref_m, **STATS_TOL)
        torch.testing.assert_close(l, ref_l, **STATS_TOL)
        err_s = max(err, float((m - ref_m).abs().max()),
                    float((l - ref_l).abs().max()))
        # raw-stats form: against its plain version, and the merged states
        # of the two kv halves against K1 over the whole kv
        ref_raw = A.flash_attention_block_reference(q, k, v, bias)
        torch.testing.assert_close(raw[1], ref_raw[1], **STATS_TOL)
        torch.testing.assert_close(raw[2], ref_raw[2], **STATS_TOL)
        err_r = max(rel_err(raw[0], ref_raw[0], RAW_REL[dt],
                            f"raw acc B={b} {dt}"),
                    float((raw[1] - ref_raw[1]).abs().max()),
                    float((raw[2] - ref_raw[2]).abs().max()))
        macc, _, ml = A.merge_block_states(halves)
        merged = (macc / ml[..., None]).to(dt)
        err_merge = max_err(merged, out, dt)
        ref = A.flash_backward_reference(q, k, v, bias, out_s, m, l, dout)
        errs = [rel_err(got, want, GRAD_REL[dt], f"{name} B={b} {dt}")
                for name, got, want in zip(("dq", "dk", "dv"),
                                           (dq, dk, dv), ref)]
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(A.mha_reference(*leaves, bias),
                                   leaves, dout.float())
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), auto):
            rel_err(got, want, 1.5 * GRAD_REL[dt],
                    f"{name} vs autograd(mha_reference) B={b} {dt}")
        # no atomics: a second call gives the same bits
        dq2, delta2 = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l,
                                               dout)
        dk2, dv2 = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l,
                                             delta2)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in
                  ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2))),
              f"backward not bit-equal across calls B={b} {dt}")
        for name, e in zip(names[:5], (err, err_s, max(err_r, err_merge),
                                       errs[0], max(errs[1:]))):
            results[name]["err"] = max(results[name]["err"], e)

        def k2():
            return A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l, dout)

        def k3():
            return A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l,
                                             delta)

        def k1_raw():
            return A.flash_attention_block(q, k, v, bias)

        def k1():
            return A.flash_attention(q, k, v, bias)

        def k1_stats():
            return A.flash_attention_with_stats(q, k, v, bias)

        plain_fwd = lambda: A.mha_reference(q, k, v, bias)  # noqa: E731
        t = {  # CUDA events around back-to-back calls
            "flash_attention_fwd": time_ms(k1),
            "flash_attention_fwd_stats": time_ms(k1_stats),
            "flash_attention_bwd_dq": time_ms(k2),
            "flash_attention_bwd_dkv": time_ms(k3),
        }
        dev = {  # device time per call, calls queued behind a spin kernel
            "flash_attention_fwd": device_ms(k1),
            "flash_attention_fwd_stats": device_ms(k1_stats),
            "flash_attention_fwd_raw": device_ms(k1_raw),
            "flash_attention_bwd_dq": device_ms(k2),
            "flash_attention_bwd_dkv": device_ms(k3),
        }
        host = {n: host_us(fn) for n, fn in (
            ("K1", k1), ("K1-stats", k1_stats), ("K1-raw", k1_raw),
            ("K2", k2), ("K3", k3))}
        plain = {
            "flash_attention_fwd": time_ms(plain_fwd),
            "flash_attention_fwd_stats": time_ms(
                lambda: A.flash_forward_reference(q, k, v, bias)),
            "flash_attention_fwd_raw": time_ms(
                lambda: A.flash_attention_block_reference(q, k, v, bias)),
            # the plain backward computes dq, dk and dv together
            "flash_attention_bwd_dq": time_ms(
                lambda: A.flash_backward_reference(q, k, v, bias, out_s, m,
                                                   l, dout), iters=10),
        }
        plain["flash_attention_bwd_dkv"] = plain["flash_attention_bwd_dq"]
        def sdpa_fn():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

        sdpa_lse_fn = _sdpa_with_lse(q, k, v, bias)
        sdpa, sdpa_dev = time_ms(sdpa_fn), device_ms(sdpa_fn)
        sdpa_lse, sdpa_lse_dev = time_ms(sdpa_lse_fn), device_ms(sdpa_lse_fn)
        sdpa_bwd_fn = _sdpa_backward(q, k, v, bias, dout)
        sdpa_bwd = time_ms(sdpa_bwd_fn, iters=10)
        sdpa_bwd_dev = device_ms(sdpa_bwd_fn, iters=10)
        if (b, sq, dt) == (64, S, torch.bfloat16):
            qkvo = 4 * _nbytes(q)
            st = _nbytes(m)  # one f32 [B,H,Sq] row statistic
            pairs = b * HEADS * sq * skv * HEAD_DIM  # multiply-adds per
            work = {  # product; (bytes, FLOPs) each input read once,
                # each output written once
                "flash_attention_fwd": (qkvo + _nbytes(bias), 4 * pairs),
                "flash_attention_fwd_stats": (qkvo + _nbytes(bias) + 2 * st,
                                              4 * pairs),
                # q, k, v in, f32 acc, m and l out
                "flash_attention_fwd_raw": (3 * _nbytes(q) + _nbytes(bias)
                                            + _nbytes(raw[0]) + 2 * st,
                                            4 * pairs),
                "flash_attention_bwd_dq": (6 * _nbytes(q) + _nbytes(bias)
                                           + 3 * st, 6 * pairs),
                "flash_attention_bwd_dkv": (6 * _nbytes(q) + _nbytes(bias)
                                            + 3 * st, 8 * pairs),
            }
            for name, (nb, fl) in work.items():
                r = results[name]
                r["ms"] = dev.get(name, t.get(name))
                r["plain_ms"] = plain[name]
                r["bound_ms"], r["bound_by"] = bound(nb, fl, dt)
                if name in t and name in dev:
                    r["events_ms"] = t[name]
            for name, lib_dev, lib_ev, wrapper in (
                    ("flash_attention_fwd", sdpa_dev, sdpa, "K1"),
                    ("flash_attention_fwd_stats", sdpa_lse_dev, sdpa_lse,
                     "K1-stats")):
                results[name].update(library_ms=lib_dev,
                                     library_events_ms=lib_ev,
                                     host_us=host[wrapper])
            for name, wrapper in (("flash_attention_fwd_raw", "K1-raw"),
                                  ("flash_attention_bwd_dq", "K2"),
                                  ("flash_attention_bwd_dkv", "K3")):
                results[name]["host_us"] = host[wrapper]
            # no PyTorch call returns the unnormalized state
            results["flash_attention_fwd_raw"]["library_ms"] = None
            # the SDPA backward computes dq, dk and dv together: one
            # library time for K2 and K3 combined
            for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                results[name]["library_ms"] = sdpa_bwd_dev
                results[name]["library_events_ms"] = sdpa_bwd
        lines.append(
            f"  flash B={b} H={HEADS} Sq={sq} Skv={skv} D={HEAD_DIM} "
            f"{str(dt)[6:]}: max_abs_err fwd {err:.3g}, stats {err_s:.3g}, "
            f"raw {err_r:.3g}, merged halves vs K1 {err_merge:.3g}, "
            f"dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}; "
            "backward bit-equal across calls; device ms (spin-queued) K1 "
            f"{dev['flash_attention_fwd']:.4f}, K1-stats "
            f"{dev['flash_attention_fwd_stats']:.4f}, "
            f"K1-raw {dev['flash_attention_fwd_raw']:.4f}, K2 "
            f"{dev['flash_attention_bwd_dq']:.4f}, K3 "
            f"{dev['flash_attention_bwd_dkv']:.4f}, K2+K3 "
            f"{dev['flash_attention_bwd_dq'] + dev['flash_attention_bwd_dkv']:.4f}"
            f", sdpa fwd {sdpa_dev:.4f}, sdpa fwd+lse {sdpa_lse_dev:.4f}, "
            f"sdpa bwd {sdpa_bwd_dev:.4f}; events ms K1 "
            f"{t['flash_attention_fwd']:.4f}, K1-stats "
            f"{t['flash_attention_fwd_stats']:.4f}, K2 "
            f"{t['flash_attention_bwd_dq']:.4f}, K3 "
            f"{t['flash_attention_bwd_dkv']:.4f}, plain fwd "
            f"{plain['flash_attention_fwd']:.4f}, plain fwd+stats "
            f"{plain['flash_attention_fwd_stats']:.4f}, plain raw "
            f"{plain['flash_attention_fwd_raw']:.4f}, plain bwd "
            f"{plain['flash_attention_bwd_dq']:.4f}, sdpa fwd {sdpa:.4f}, "
            f"sdpa fwd+lse {sdpa_lse:.4f}, sdpa bwd {sdpa_bwd:.4f}; host us "
            "per wrapper call " + ", ".join(
                f"{n} {us:.1f}" for n, us in host.items()))
    results["layer_norm"], results["layer_norm_bwd"] = _layer_norm_cases(
        g, lines)
    results["int8_dequant_gemm"] = _k5_cases(g, lines)
    print(f"phase kernels: ok (card '{card}'; tolerances f32 "
          f"{TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}; stats "
          f"{STATS_TOL}; gradients relative {GRAD_REL[torch.float32]} / "
          f"{GRAD_REL[torch.bfloat16]} of the largest entry, 1.5x that "
          "against autograd through mha_reference; K4-bwd dx relative "
          f"{LN_DX_REL[torch.float32]} / {LN_DX_REL[torch.bfloat16]}, "
          f"dscale and dbias {LN_PARAM_REL}; "
          "K5 f32 within 2 ulp of its epilogue's operands, bf16 within 1 "
          "bf16 ulp)")
    print("\n".join(lines))
    return results


def rotating(fn, sets):
    """A callable that runs ``fn(*set)`` on the next of ``sets`` at each
    call, so that calls timed back to back read device memory, not L2."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def _ln_sets(pool, rows, per_call_bytes):
    """Input sets (x, residual, dy) of ``rows`` rows cut from ``pool``
    ([n, R, H] tensors, R a multiple of ``rows``): at least three, and at
    least ROTATE_BYTES of what one call reads in all."""
    n = max(3, math.ceil(ROTATE_BYTES / per_call_bytes))
    per = pool[0].shape[1] // rows
    check(n <= pool[0].shape[0] * per, f"{n} LayerNorm input sets at {rows} "
          "rows: the pool is too small")
    return [tuple(t[i // per, (i % per) * rows:(i % per + 1) * rows]
                  for t in pool) for i in range(n)]


def _ln_library_backward(x, residual, w, bb, dy):
    """One F.layer_norm forward after the residual add (weights in x's
    dtype), and a callable running its backward alone: dx, dweight and
    dbias (the add's backward launches nothing)."""
    h = (x if residual is None else x + residual).detach().requires_grad_()
    leaves = [h] + [t.detach().to(x.dtype, copy=True).requires_grad_()
                    for t in (w, bb)]
    y = F.layer_norm(h, (HIDDEN,), leaves[1], leaves[2], 1e-12)
    return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


def _ln_plain_vjp(x, residual, w, bb, dy):
    """The backward before K4-bwd (and JAX's): autograd's VJP of the plain
    forward, recomputed. A callable running it."""
    leaves = [t.detach().requires_grad_()
              for t in (x, residual, w, bb) if t is not None]
    xi, *rest = leaves
    ri = rest.pop(0) if residual is not None else None
    y = L._ln_reference(xi, ri, rest[0], rest[1], 1e-12)
    return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


def _layer_norm_cases(g, lines):
    """K4 in its four forms (bf16 and f32, with and without the residual)
    at the training step's [14592, 768] and bf16 at bucket 32's [7296,
    768], and K4-bwd in the four forms at [14592, 768]: each against its
    plain version, bit-equal across two calls (K4-bwd), and timed by
    device_ms over rotating input sets beside its plain version and
    F.layer_norm (forward, or backward), with the wrapper's host time.
    Returns the kernels line's rows of K4 and K4-bwd (bf16 with the
    residual), each with all forms under "forms"."""
    rows = TRAIN_B * S
    fwd = {"err": 0.0, "forms": {}}
    bwd = {"err": 0.0, "forms": {}}
    for dt in (torch.bfloat16, torch.float32):
        pool = [torch.randn(LN_POOL, rows, HIDDEN, device=DEV,
                            generator=g).to(dt) for _ in range(3)]
        w = 1.0 + 0.1 * torch.randn(HIDDEN, device=DEV, generator=g)
        bb = 0.1 * torch.randn(HIDDEN, device=DEV, generator=g)
        w_dt, bb_dt = w.to(dt), bb.to(dt)  # F.layer_norm's weights, cast once
        elt = pool[0].element_size()
        shapes = [rows] + ([SERVE_B * S] if dt == torch.bfloat16 else [])
        for n_rows, with_res in ((r, wr) for r in shapes
                                 for wr in (False, True)):
            form = (f"{str(dt)[6:]} [{n_rows}, {HIDDEN}] "
                    f"{'residual' if with_res else 'no residual'}")
            row_bytes = n_rows * HIDDEN * elt
            sets = _ln_sets(pool, n_rows, (2 if with_res else 1) * row_bytes)
            x, res, dy = sets[0]
            res = res if with_res else None
            out = L.layer_norm_kernel(x, w, bb, res)
            torch.cuda.synchronize()
            err = max_err(out, L._ln_reference(x, res, w, bb, 1e-12), dt)
            fwd["err"] = max(fwd["err"], err)

            def kern(x_, r_, _dy):
                return L.layer_norm_kernel(x_, w, bb, r_ if with_res else None)

            def stock(x_, r_, _dy):
                return F.layer_norm(x_ + r_ if with_res else x_, (HIDDEN,),
                                    w_dt, bb_dt, 1e-12)

            def plain(x_, r_, _dy):
                return L._ln_reference(x_, r_ if with_res else None, w, bb,
                                       1e-12)

            f = {"ms": device_ms(rotating(kern, sets)),
                 "library_ms": device_ms(rotating(stock, sets)),
                 "plain_ms": device_ms(rotating(plain, sets), iters=5),
                 "events_ms": time_ms(rotating(kern, sets)),
                 "host_us": host_us(lambda: L.layer_norm_kernel(x, w, bb,
                                                                res))}
            f["bound_ms"], f["bound_by"] = bound(
                _nbytes(x, res, w, bb, out), 8 * x.numel(), dt)
            f["bound_share"] = f["bound_ms"] / f["ms"]
            fwd["forms"][form] = f
            lines.append(
                f"  K4 {form}: max_abs_err {err:.3g}; device ms (rotating "
                f"{len(sets)} input sets): kernel {f['ms']:.4f}, "
                f"F.layer_norm{'(+add)' if with_res else ''} "
                f"{f['library_ms']:.4f}, plain {f['plain_ms']:.4f}; bound "
                f"{f['bound_ms']:.4f} by {f['bound_by']} (kernel at "
                f"{100 * f['bound_share']:.0f}% of it); events over "
                f"back-to-back calls {f['events_ms']:.4f}; host "
                f"{f['host_us']:.1f} us a call"
                + ("; UNDER THE BOUND: L2 was read" if f["ms"] < f["bound_ms"]
                   else ""))
            if n_rows != rows:
                continue
            # the backward: K4-bwd against the plain backward, two calls
            # bit-equal, timed beside the plain backward, the old plain
            # VJP and F.layer_norm's backward
            sets = _ln_sets(pool, n_rows, (3 if with_res else 2) * row_bytes)
            x, res, dy = sets[0]
            res = res if with_res else None
            got = L.layer_norm_backward_kernel(x, w, dy, res)
            again = L.layer_norm_backward_kernel(x, w, dy, res)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K4-bwd {form}: not bit-equal across calls")
            want = L._ln_backward_reference(x, res, w, bb, dy, 1e-12)
            errs = [rel_err(a, b, rel, f"K4-bwd {name} {form}")
                    for name, a, b, rel in zip(
                        ("dx", "dscale", "dbias"), got,
                        (want[0], want[2], want[3]),
                        (LN_DX_REL[dt], LN_PARAM_REL, LN_PARAM_REL))]
            bwd["err"] = max(bwd["err"], *errs)

            def kern_bwd(x_, r_, dy_):
                return L.layer_norm_backward_kernel(
                    x_, w, dy_, r_ if with_res else None)

            def plain_bwd(x_, r_, dy_):
                return L._ln_backward_reference(
                    x_, r_ if with_res else None, w, bb, dy_, 1e-12)

            lib = [_ln_library_backward(x_, r_ if with_res else None, w, bb,
                                        dy_) for x_, r_, dy_ in sets]
            vjp = [_ln_plain_vjp(x_, r_ if with_res else None, w, bb, dy_)
                   for x_, r_, dy_ in sets]
            b = {"ms": device_ms(rotating(kern_bwd, sets)),
                 "library_ms": device_ms(rotating(lambda f_: f_(),
                                                  [(f_,) for f_ in lib])),
                 "plain_ms": device_ms(rotating(plain_bwd, sets), iters=5),
                 "plain_vjp_ms": device_ms(rotating(
                     lambda f_: f_(), [(f_,) for f_ in vjp]), iters=5),
                 "events_ms": time_ms(rotating(kern_bwd, sets)),
                 "host_us": host_us(lambda: L.layer_norm_backward_kernel(
                     x, w, dy, res))}
            del lib, vjp
            b["bound_ms"], b["bound_by"] = bound(
                _nbytes(x, res, w, dy, got[0], got[1], got[2]),
                10 * x.numel(), dt)
            b["bound_share"] = b["bound_ms"] / b["ms"]
            bwd["forms"][form] = b
            lines.append(
                f"  K4-bwd {form}: max_abs_err dx {errs[0]:.3g}, dscale "
                f"{errs[1]:.3g}, dbias {errs[2]:.3g}; bit-equal across "
                f"calls; device ms (rotating {len(sets)} input sets): "
                f"kernel {b['ms']:.4f}, F.layer_norm backward "
                f"{b['library_ms']:.4f}, plain backward {b['plain_ms']:.4f},"
                f" plain VJP (the backward before K4-bwd) "
                f"{b['plain_vjp_ms']:.4f}; bound {b['bound_ms']:.4f} by "
                f"{b['bound_by']} (kernel at "
                f"{100 * b['bound_share']:.0f}% of it); events over "
                f"back-to-back calls {b['events_ms']:.4f}; host "
                f"{b['host_us']:.1f} us a call"
                + ("; UNDER THE BOUND: L2 was read" if b["ms"] < b["bound_ms"]
                   else ""))
        del pool
        torch.cuda.empty_cache()
    headline = f"bfloat16 [{rows}, {HIDDEN}] residual"
    for row in (fwd, bwd):
        row.update({k: v for k, v in row["forms"][headline].items()
                    if k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by", "host_us", "events_ms",
                             "plain_vjp_ms")})
    return fwd, bwd


def k5_error(got, x8, w8, xs, ws, bias, out_dtype, what):
    """Max abs error of K5 against its plain version, checked elementwise:
    f32 output within 2 ulp of the epilogue's operands (|y xs ws| + |b|),
    bf16 output within 1 bf16 ulp of the plain result."""
    ref = Q.dequant_gemm_reference(x8, w8, xs, ws, bias, out_dtype).float()
    err = (got.float() - ref).abs()
    if out_dtype == torch.float32:
        scaled = Q.dequant_gemm_reference(x8, w8, xs, ws, None,
                                          torch.float32).abs()
        allowed = 2.0 ** -22 * (scaled + (0 if bias is None else bias.abs()))
    else:
        _, exponent = torch.frexp(ref)  # |ref| in [2^(e-1), 2^e)
        allowed = torch.ldexp(torch.ones_like(ref), exponent - 8)
    bad = int((err > allowed).sum())
    check(not torch.isnan(got).any() and bad == 0,
          f"{what}: {bad} entries beyond the bound, max abs err "
          f"{float(err.max())}")
    return float(err.max())


def _k5_operands(m, k, n, g):
    """Quantised operands as the trunk makes them: activations ~N(0, 1),
    weights ~N(0, 0.02) as init_weights draws them, a small bias."""
    x = torch.randn(m, k, device=DEV, generator=g).to(torch.bfloat16)
    w = 0.02 * torch.randn(n, k, device=DEV, generator=g)
    bias = 0.1 * torch.randn(n, device=DEV, generator=g)
    x8, xs = Q.quantize_rows(x)
    w8, ws = Q.quantize_rows(w, eps=1e-11)
    return x8, w8, xs.reshape(-1), ws.reshape(-1), bias


def _k5_cases(g, lines):
    """K5 against its plain version at the main paths' shapes; returns its
    row of the kernels report (the headline shape's times)."""
    row = {"err": 0.0}
    cases = [(shape, torch.bfloat16) for shape in K5_MMBT]
    cases += [(K5_VB, torch.float32), (K5_VB, torch.bfloat16)]
    per_forward = 0.0
    for (m, k, n), dt in cases:
        x8, w8, xs, ws, bias = _k5_operands(m, k, n, g)
        out = Q.dequant_gemm(x8, w8, xs, ws, bias, dt)
        torch.cuda.synchronize()
        err = k5_error(out, x8, w8, xs, ws, bias, dt, f"K5 {m}x{k}x{n} {dt}")
        row["err"] = max(row["err"], err)
        # device time per call: at M = 131 back-to-back launches through
        # the Python wrapper measure the host's launch rate, not the
        # kernel (time_ms gives that rate, printed too)
        def kern_fn():
            return Q.dequant_gemm(x8, w8, xs, ws, bias, dt)

        kern = device_ms(kern_fn)
        wrapper_ms = time_ms(kern_fn)
        wrapper_us = host_us(kern_fn)
        plain = device_ms(lambda: Q.dequant_gemm_reference(
            x8, w8, xs, ws, bias, dt), iters=5)
        w8t = w8.t()  # [K, N], column-major: cuBLASLt's int8 layout
        # torch._int_mm takes M > 16 only
        lib = (device_ms(lambda: torch._int_mm(x8, w8t)) if m > 16
               else None)
        nbytes = _nbytes(x8, w8, xs, ws, bias, out)
        b_ms, b_by = bound(nbytes, 2 * m * n * k, torch.int8)
        if ((m, k, n), dt) == (K5_HEADLINE, torch.bfloat16):
            row.update(ms=kern, plain_ms=plain, library_ms=lib,
                       bound_ms=b_ms, bound_by=b_by, host_us=wrapper_us)
        if (m, k, n) in K5_MMBT:
            per_forward += K5_MMBT[(m, k, n)] * kern
        lines.append(
            f"  int8_gemm M={m} K={k} N={n} -> {str(dt)[6:]}: max_abs_err "
            f"{err:.3g}; device ms per call: kernel {kern:.4f} "
            f"({2e-9 * m * n * k / kern:.1f} TOP/s), plain {plain:.4f}, "
            f"torch._int_mm (int32 product alone) "
            f"{'n/a' if lib is None else f'{lib:.4f}'}; bound {b_ms:.4f} "
            f"by {b_by}; {Q.k5_tile(m, n)}-wide tiles; "
            f"back-to-back calls through the wrapper (CUDA events) "
            f"{wrapper_ms:.4f} ms each, host {wrapper_us:.1f} us a call")
    lines.append(f"  int8_gemm per MMBT forward at batch 1 (73 launches): "
                 f"{per_forward:.4f} ms of kernel device time")
    return row


def cpu_forward(model, sample):
    """One sample through ``model`` on the CPU (the plain versions)."""
    def batch_of_one(tree):
        if isinstance(tree, dict):
            return {k: batch_of_one(v) for k, v in tree.items()}
        if isinstance(tree, (np.ndarray, np.generic)):
            return torch.from_numpy(np.asarray(tree)[None])
        return tree  # meta strings

    model.eval().to_compute_dtype()
    batch = batch_of_one(sample)
    with torch.inference_mode():
        out = model(batch)
    return {k: v[0].float().numpy() for k, v in out.items()}


# -- phase 3 ---------------------------------------------------------------
def _request(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=body,
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, payload = r.status, json.loads(r.read())
    return status, payload, time.perf_counter() - t0


def _fields_body(sample):
    def conv(v):
        return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) \
            else np.asarray(v).tolist()
    return json.dumps({"fields": conv(sample)}).encode()


def phase_serving(card):
    model = flagship.visual_bert()
    cfg = model.config
    check((cfg["hidden_size"], cfg["num_hidden_layers"],
           cfg["num_attention_heads"], cfg["num_labels"],
           cfg["dtype"]) == (HIDDEN, 12, HEADS, 3129, "bfloat16"), cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())

    samples = flagship.split_samples(flagship.example_batch(
        N_REQUESTS, SEQ, REGIONS, VDIM, seed=0))
    samples[3]["image_info_0"]["max_features"] = np.int32(37)
    bodies = [_fields_body(s) for s in samples]

    engine = ServingEngine(model, device=DEV, max_batch_size=32)
    server = ServingServer(engine, host="127.0.0.1", port=0,
                           max_wait_ms=20.0).start()
    try:
        t0 = time.perf_counter()
        warmed = engine.warmup(samples[0])
        warm_s = time.perf_counter() - t0
        stats0 = server.stats()["batcher"]

        # the main path, counted from zero
        reset_counts()
        replies = [None] * N_REQUESTS

        def send(i):
            replies[i] = _request(server.port, bodies[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        launches = read_counts()
        stats1 = server.stats()["batcher"]
        check(not any(t.is_alive() for t in threads), "a request hung")
        for status, payload, _ in replies:
            check(status == 200, payload)
            scores = np.asarray(payload["scores"], np.float32)
            check(scores.shape == (3129,), f"scores shape {scores.shape}")
            check(np.isfinite(scores).all(), "non-finite scores")
        batches = stats1["batches"] - stats0["batches"]
        # per forward: 12 attention calls; 24 residual LayerNorms plus the
        # embedding and the classifier-head LayerNorm
        want = dict(ZERO_COUNTS, flash_attention_fwd=12 * batches,
                    layer_norm=26 * batches)
        check(batches >= 1 and launches == want,
              f"launches {launches}, want {want} for {batches} batch(es)")
        lat = sorted(r[2] for r in replies)
        p50_ms = 1000 * lat[len(lat) // 2]

        # one request's served scores vs the f32 CPU forward (plain
        # versions) on the same weights
        ref_model = flagship.visual_bert({"dtype": "float32"})
        ref_model.load_state_dict(cpu_state, strict=True)
        probe = 3  # the request with max_features = 37
        ref = cpu_forward(ref_model, samples[probe])["scores"]
        got = np.asarray(replies[probe][1]["scores"], np.float32)
        err = float(np.abs(got - ref).max())
        cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
        check(err <= SERVE_ATOL and cos >= SERVE_MIN_COSINE,
              f"served vs f32 CPU: max_abs_err {err}, cosine {cos}")

        # engine throughput at bucket 32 (stack, pad, one H2D copy,
        # forward, D2H), after the counted run
        batch32 = [samples[i % N_REQUESTS] for i in range(32)]
        engine.predict_many(batch32)
        iters = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.predict_many(batch32)
        sps = 32 * iters / (time.perf_counter() - t0)
        # device forward alone at bucket 32
        arrays, _ = engine_lib._split_static(
            engine_lib._stack_samples(batch32))
        dev_batch = engine_lib._to_device(arrays, DEV)
        def forward():
            with torch.inference_mode():
                engine.model(dev_batch)

        fwd_ms = time_ms(forward, iters=5, repeats=3)
        dev_ms, by_category = _device_ms(forward, 3)
    finally:
        server.shutdown()
    print(f"phase serving: ok VisualBERT-base {n_params / 1e6:.1f}M params "
          f"bf16; warmup buckets {list(warmed)} in {warm_s:.1f}s; "
          f"{N_REQUESTS} concurrent requests all 200, scores [3129] finite, "
          f"{batches} batch(es); launches {launches}; served-vs-f32-CPU "
          f"max_abs_err={err:.4g} (bound {SERVE_ATOL}) cosine={cos:.6f}")
    print(f"  serving on '{card}': {sps:.1f} samples/s at bucket 32 "
          f"(engine predict_many, host stacking and copies included); "
          f"forward alone {fwd_ms:.2f} ms at bucket 32; concurrent request "
          f"p50 {p50_ms:.1f} ms (client side, {N_REQUESTS} requests, "
          f"JSON of ~{len(bodies[0]) / 1e6:.1f} MB each); batcher p50 "
          f"{stats1['latency_ms']['p50']:.1f} ms")
    print(f"  bf16 forward at bucket 32: device time {dev_ms:.3f} ms "
          "(torch.profiler, 3 forwards): " + "; ".join(
              f"{cat} {ms:.3f} x{cnt:.0f}" for cat, (ms, cnt) in
              sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    return launches, {"state": cpu_state, "batch32": batch32,
                      "fwd_ms": fwd_ms, "probe": probe, "ref_f32": ref}


# -- phase 4 ---------------------------------------------------------------
@contextlib.contextmanager
def plain_versions():
    """The trunk's attention and LayerNorm swapped for their plain
    versions on the card, for the kernel-vs-plain step comparison only."""
    attn, ln = T.dot_product_attention, T.layer_norm
    T.dot_product_attention = (
        lambda q, k, v, bias=None, scale=None, dropout_rate=0.0,
        generator=None: A.mha_reference(q, k, v, bias, scale, dropout_rate,
                                        generator))
    T.layer_norm = (lambda x, scale, bias, residual=None, eps=1e-12:
                    L._ln_reference(x, residual, scale, bias, eps))
    try:
        yield
    finally:
        T.dot_product_attention, T.layer_norm = attn, ln


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return 1.0 if den == 0.0 else float(a @ b) / den


def _norm_rel(got, want):
    """||got - want|| / ||want||: unlike the cosine, it sees scale."""
    got, want = got.double(), want.double()
    den = float(want.norm())
    return float((got - want).norm()) / den if den else float(got.norm())


DEVICE_CATEGORIES = (  # kernel-name fragment -> category, first match
    (("flash_fwd", "bwd_dq_", "bwd_dkv_"), "attention K1/K2/K3"),
    (("_ln_fwd_kernel",), "LayerNorm K4"),
    (("ln_bwd_",), "LayerNorm backward K4-bwd"),
    (("int8_gemm",), "int8 GEMM K5"),
    (("fprop", "conv", "winograd", "implicit_gemm", "cudnn"),
     "convolutions (cuDNN)"),
    (("bn_fw", "batch_norm"), "BatchNorm"),
    (("nvjet", "gemm", "cutlass", "sm90_", "xmma"), "GEMMs"),
    (("multi_tensor_apply",), "optimizer"),
)


def _category(name):
    for fragments, category in DEVICE_CATEGORIES:
        if any(f in name for f in fragments):
            return category
    return "elementwise, reductions, copies"


def _device_ms(step_fn, n):
    """Device time per step from torch.profiler over ``n`` steps: the sum
    of the kernels' self time, and that sum by category of kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step_fn()
        torch.cuda.synchronize()
    by_category = {}
    for e in prof.key_averages():
        # device-side kernels only; user annotations (the optimizer's
        # record_function range) span kernels and would count them twice
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_user_annotation", False) or e.key.startswith(
                ("Optimizer.", "ProfilerStep")):
            continue
        ms = (getattr(e, "self_device_time_total", None)
              or e.self_cuda_time_total) / 1e3 / n
        cat = _category(e.key)
        total, count = by_category.get(cat, (0.0, 0.0))
        by_category[cat] = (total + ms, count + e.count / n)
    return sum(v[0] for v in by_category.values()), by_category


def _compared_steps(cfg, state_dict, batch):
    """COMPARED_STEPS steps at dropout 0 from ``state_dict``: (losses,
    gradients of the first step, parameter updates after all, launch
    counts). The schedule's update 0 runs at lr 0, so the first two
    losses are taken at the initial weights and the third after an
    update at lr > 0."""
    model = flagship.vqa2_visual_bert(cfg, {"hidden_dropout_prob": 0.0})
    model.load_state_dict(state_dict, strict=True)
    state, step = flagship.vqa2_trainer(model, cfg, seed=1)
    losses, grads = [], None
    reset_counts()
    for _ in range(COMPARED_STEPS):
        state, rep = step(state, batch)
        losses.append(float(rep["total_loss"]))
        if grads is None:
            grads = {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters()}
    launches = read_counts()
    updates = {n: p.detach().cpu() - state_dict[n]
               for n, p in model.named_parameters()}
    return losses, grads, updates, launches


def phase_training(card):
    cfg = flagship.vqa2_config([
        # the flash kernel has no probabilities to drop (as in JAX)
        "model_config.visual_bert.attention_probs_dropout_prob=0.0",
        # so that the lr is above 0 within the run
        "scheduler.params.num_warmup_steps=2",
    ])
    model = flagship.vqa2_visual_bert(cfg)
    mc = model.config
    check((mc["hidden_size"], mc["num_hidden_layers"],
           mc["num_attention_heads"], mc["num_labels"], mc["dtype"],
           mc["hidden_dropout_prob"], mc["attention_probs_dropout_prob"])
          == (HIDDEN, 12, HEADS, 3129, "bfloat16", 0.1, 0.0), dict(mc))
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    model = model.to(DEV)
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "master parameters must stay f32")
    state, step = flagship.vqa2_trainer(model, cfg, seed=0)
    groups = [(g["weight_decay"], len(g["params"]))
              for g in state.optimizer.param_groups]
    batch = train_state._to_device(flagship.vqa2_train_batch(
        TRAIN_B, SEQ, REGIONS, VDIM, seed=0), DEV)

    t0 = time.perf_counter()
    state, rep = step(state, batch)  # warm-up
    warm_loss = float(rep["total_loss"])
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    # the main path, counted from zero
    reset_counts()
    losses, step_ms, lrs = [], [], []
    for _ in range(TRAIN_STEPS):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        t0 = time.perf_counter()
        state, rep = step(state, batch)
        losses.append(float(rep["total_loss"]))  # synchronises
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in [warm_loss] + losses)
          and not bool(rep["nan_flag"]), f"losses {losses}")
    check(lrs[0] > 0.0, f"lr {lrs}")
    # per step: 12 attention calls (stats form forward, K2 and K3 in the
    # backward, no inference form); 26 LayerNorms (embedding, 24 residual,
    # classifier head), each a K4 forward and a K4-bwd backward
    want = dict(ZERO_COUNTS, flash_attention_fwd_stats=12 * TRAIN_STEPS,
                flash_attention_bwd_dq=12 * TRAIN_STEPS,
                flash_attention_bwd_dkv=12 * TRAIN_STEPS,
                layer_norm=26 * TRAIN_STEPS,
                layer_norm_bwd=26 * TRAIN_STEPS)
    check(launches == want, f"training launches {launches}, want {want}")

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    dev_ms, by_category = _device_ms(one_step, 2)
    best_ms = min(step_ms)
    del state, step, model, rep
    torch.cuda.empty_cache()

    # kernels vs plain versions: same weights, same batch, dropout 0
    k_losses, k_grads, k_upd, k_launches = _compared_steps(cfg, init, batch)
    with plain_versions():
        p_losses, p_grads, p_upd, p_launches = _compared_steps(cfg, init,
                                                               batch)
    want_k = {name: count * COMPARED_STEPS // TRAIN_STEPS
              for name, count in want.items()}
    check(k_launches == want_k, f"kernel side launches {k_launches}")
    check(p_launches == ZERO_COUNTS, f"plain side launches {p_launches}")
    check(k_losses[1] == k_losses[0] and k_losses[2] != k_losses[1],
          f"update 0 at lr 0 and update 1 above it: losses {k_losses}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    # the key bias's true gradient is 0 (softmax is shift-invariant along
    # keys): both sides hold rounding noise there, so it is left out
    compared = [n for n in k_grads if not n.endswith("key.bias")]
    g_cos = {n: _cosine(k_grads[n], p_grads[n]) for n in compared}
    g_rel = {n: _norm_rel(k_grads[n], p_grads[n]) for n in compared}
    u_cos = {n: _cosine(k_upd[n], p_upd[n]) for n in compared}
    worst_g = min(g_cos, key=g_cos.get)
    worst_r = max(g_rel, key=g_rel.get)
    worst_u = min(u_cos, key=u_cos.get)
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"kernel vs plain losses {k_losses} / {p_losses}")
    check(g_cos[worst_g] >= TRAIN_MIN_GRAD_COSINE,
          f"gradient cosine {g_cos[worst_g]} at {worst_g}")
    check(g_rel[worst_r] <= TRAIN_MAX_GRAD_REL,
          f"gradient norm-relative error {g_rel[worst_r]} at {worst_r}")
    check(u_cos[worst_u] >= TRAIN_MIN_UPDATE_COSINE,
          f"update cosine {u_cos[worst_u]} at {worst_u}")

    print(f"phase training: ok VisualBERT-base {n_params / 1e6:.1f}M f32 "
          f"params, bf16 compute, B={TRAIN_B}; warm-up step {warm_s:.1f}s "
          f"loss {warm_loss:.4f}; {TRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]} all finite, lr {lrs[0]:.3g} -> "
          f"{lrs[-1]:.3g}; optimizer groups (weight decay, params) "
          f"{groups}; launches {launches} (exact per step)")
    print(f"  training on '{card}': ms per step "
          f"{[round(x, 2) for x in step_ms]} (best {best_ms:.2f}), "
          f"{TRAIN_B * 1e3 / best_ms:.1f} samples/s at best, "
          f"{TRAIN_B * 1e3 * TRAIN_STEPS / sum(step_ms):.1f} mean; device "
          f"time {dev_ms:.2f} ms per step (torch.profiler, 2 steps) against "
          f"{best_ms:.2f} ms wall; max_memory_allocated {peak_gb:.2f} GB")
    print("  device time per step by kind of kernel (ms, launches): "
          + "; ".join(f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                      sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    print(f"  kernels vs plain versions, {COMPARED_STEPS} steps at dropout "
          f"0 (launches {k_launches} vs {p_launches}): losses {k_losses} vs "
          f"{p_losses} (max rel {loss_rel:.3g}, bound {TRAIN_LOSS_RTOL}); "
          f"first-step gradients: cosine min {g_cos[worst_g]:.6f} at "
          f"{worst_g} (bound {TRAIN_MIN_GRAD_COSINE}), |g_k - g_p| / |g_p| "
          f"max {g_rel[worst_r]:.3g} at {worst_r} (bound "
          f"{TRAIN_MAX_GRAD_REL}); update cosine after {COMPARED_STEPS} "
          f"steps min {u_cos[worst_u]:.6f} at {worst_u} (bound "
          f"{TRAIN_MIN_UPDATE_COSINE}); {len(compared)} of {len(k_grads)} "
          "parameters compared (attention key biases left out)")
    return launches


# -- phase 5 ---------------------------------------------------------------
def _mmbt(state=None, **overrides):
    """MMBT-grid with fused_feature_only (the pooled features come back
    beside the scores): seeded weights, or ``state``."""
    model = flagship.mmbt_grid(dict({"fused_feature_only": True},
                                    **overrides))
    if state is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state, strict=True)
    return model


def _compare(got, want, what, atol=MMBT_ATOL, min_cos=MMBT_MIN_COSINE,
             enforce=True):
    """(max abs error over scores and pooled features, the features'
    cosine), checked against the bounds when ``enforce``."""
    err = max(float(np.abs(np.asarray(got[k], np.float32) - want[k]).max())
              for k in ("scores", "fused_feature"))
    a, b = np.asarray(got["fused_feature"], np.float64), want[
        "fused_feature"].astype(np.float64)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    if enforce:
        check(err <= atol and cos >= min_cos,
              f"{what}: max_abs_err {err} (bound {atol}), cosine {cos} "
              f"(bound {min_cos})")
    return err, cos


def _serve_batch1(model, sample, k5_per_forward):
    """Serve ``sample`` at batch 1 LATENCY_CALLS times, counted from zero:
    (launches, latencies in ms, last output, device ms per forward and
    its breakdown)."""
    engine = ServingEngine(model, device=DEV, max_batch_size=1)
    engine.warmup(sample)
    engine.predict(sample)
    torch.cuda.synchronize()
    reset_counts()  # the main path, counted from zero
    lat = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        out = engine.predict(sample)  # outputs copied back to the host
        lat.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    launches = read_counts()
    want = dict(ZERO_COUNTS, int8_dequant_gemm=k5_per_forward * LATENCY_CALLS,
                **{k: v * LATENCY_CALLS for k, v in MMBT_PER_FORWARD.items()})
    check(launches == want, f"MMBT launches {launches}, want {want}")
    check(np.asarray(out["scores"]).shape == (2,)
          and np.asarray(out["fused_feature"]).shape == (HIDDEN,)
          and all(np.isfinite(np.asarray(v)).all() for v in out.values()),
          f"MMBT output {out}")
    arrays, _ = engine_lib._split_static(engine_lib._stack_samples([sample]))
    dev_batch = engine_lib._to_device(arrays, DEV)

    def forward():
        with torch.inference_mode():
            engine.model(dev_batch)

    dev_ms, by_category = _device_ms(forward, 5)
    return launches, lat, out, dev_ms, by_category


def phase_mmbt(card):
    model = _mmbt()
    mc = model.config
    text = mc["text_encoder"]["params"]
    check((text["hidden_size"], text["num_hidden_layers"],
           text["num_attention_heads"], mc["num_labels"], mc["dtype"],
           model.encoder_name) == (HIDDEN, 12, HEADS, 2, "bfloat16",
                                   "ResNet152ImageEncoder_0"), dict(mc))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    sample = flagship.split_samples(flagship.hateful_memes_example_batch(
        1, seed=0))[0]
    os.environ["MMF_TPU_QUANT"] = "int8"  # the route mmf_serve takes
    try:
        env_model = _mmbt(state)
    finally:
        del os.environ["MMF_TPU_QUANT"]
    for m, k5 in ((model, 0), (env_model, MMBT_K5)):
        check(sum(isinstance(x, Q.QuantDense) for x in m.modules()) == k5,
              f"QuantDense modules, want {k5}")

    # the ResNet features under cuDNN's default (TF32 on) and with TF32
    # off, against the f32 CPU forward
    tf32 = torch.backends.cudnn.allow_tf32
    image = torch.from_numpy(sample["image"][None])
    ref_model = _mmbt(state, dtype="float32")
    encoder = getattr(ref_model, ref_model.encoder_name).eval()
    with torch.inference_mode():
        feat_cpu = encoder(image).numpy()
        encoder.to(DEV)
        feat_tf32 = encoder(image.to(DEV)).cpu().numpy()
        torch.backends.cudnn.allow_tf32 = False
        feat_f32 = encoder(image.to(DEV)).cpu().numpy()
        torch.backends.cudnn.allow_tf32 = tf32
    encoder.cpu()
    scale = float(np.abs(feat_cpu).max())
    tf32_rel = float(np.abs(feat_tf32 - feat_cpu).max()) / scale
    f32_rel = float(np.abs(feat_f32 - feat_cpu).max()) / scale
    check(tf32_rel <= MMBT_TF32_REL, f"ResNet TF32 features rel err "
          f"{tf32_rel} (bound {MMBT_TF32_REL})")
    ref_f32 = cpu_forward(ref_model, sample)
    ref_int8 = cpu_forward(_mmbt(state, quant="int8"), sample)

    runs, launches = {}, dict(ZERO_COUNTS)
    for name, m, k5 in (("bf16", model, 0),
                        ("int8 (config)", _mmbt(state, quant="int8"),
                         MMBT_K5),
                        ("int8 (MMF_TPU_QUANT)", env_model, MMBT_K5)):
        counts, lat, out, dev_ms, by_category = _serve_batch1(m, sample, k5)
        runs[name] = (lat, out, dev_ms, by_category)
        launches = {k: launches[k] + counts[k] for k in launches}
        m.cpu()
        torch.cuda.empty_cache()
    bf16_err = _compare(runs["bf16"][1], ref_f32, "MMBT bf16 vs f32 CPU")
    int8_err = _compare(runs["int8 (config)"][1], ref_int8,
                        "MMBT int8 vs int8 CPU (plain versions)")
    env_err = _compare(runs["int8 (MMF_TPU_QUANT)"][1], ref_int8,
                       "MMBT int8 (MMF_TPU_QUANT) vs int8 CPU")
    info_err = _compare(runs["int8 (config)"][1], ref_f32, "", enforce=False)

    print(f"phase mmbt: ok MMBT-grid {n_params / 1e6:.1f}M params "
          f"(ResNet-152 at 224 px, 12 x {HIDDEN}, 2 labels, bf16 compute) "
          f"at batch 1; launches per forward {MMBT_PER_FORWARD} plus K5 0 "
          f"(bf16) and {MMBT_K5} (int8, by config and by MMF_TPU_QUANT), "
          f"exact over {LATENCY_CALLS} calls each; max_abs_err / pooled "
          f"cosine: bf16 vs f32 CPU {bf16_err[0]:.4g} / {bf16_err[1]:.6f}, "
          f"int8 vs int8 CPU {int8_err[0]:.4g} / {int8_err[1]:.6f}, "
          f"MMF_TPU_QUANT int8 vs int8 CPU {env_err[0]:.4g} / "
          f"{env_err[1]:.6f} (bounds {MMBT_ATOL} / {MMBT_MIN_COSINE}); "
          f"int8 vs f32 CPU (information) {info_err[0]:.4g} / "
          f"{info_err[1]:.6f}")
    print(f"  ResNet-152 convolutions under cudnn.allow_tf32={tf32} "
          f"(cuDNN's default): features max abs err {tf32_rel:.3g} of the "
          f"largest |feature| against f32 on the CPU (bound "
          f"{MMBT_TF32_REL}); {f32_rel:.3g} with TF32 off")
    for name, (lat, _, dev_ms, by_category) in runs.items():
        print(f"  MMBT {name} on '{card}': batch-1 latency p50 "
              f"{np.percentile(lat, 50):.3f} ms, p95 "
              f"{np.percentile(lat, 95):.3f} ms over {LATENCY_CALLS} calls "
              f"(host clock, ServingEngine.predict, outputs on the host); "
              f"device time {dev_ms:.3f} ms per forward (torch.profiler, 5 "
              "forwards): " + "; ".join(
                  f"{cat} {ms:.3f} x{cnt:.0f}" for cat, (ms, cnt) in
                  sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    return launches


# -- phase 6 ---------------------------------------------------------------
def phase_vb_int8(card, serving):
    model = flagship.visual_bert({"quant": "int8"})
    model.load_state_dict(serving["state"], strict=True)
    check(sum(isinstance(m, Q.QuantDense) for m in model.modules())
          == VB_K5, "QuantDense modules")
    engine = ServingEngine(model, device=DEV, max_batch_size=32)
    batch32 = serving["batch32"]
    with _k5_shapes() as shapes:  # K5's shapes, from the warm-up forward
        engine.predict_many(batch32)
    torch.cuda.synchronize()
    reset_counts()  # the main path, counted from zero
    outs = engine.predict_many(batch32)
    torch.cuda.synchronize()
    launches = read_counts()
    want = dict(ZERO_COUNTS, flash_attention_fwd=12, layer_norm=26,
                int8_dequant_gemm=VB_K5)
    check(launches == want, f"VisualBERT int8 launches {launches}, want "
          f"{want}")
    arrays, _ = engine_lib._split_static(engine_lib._stack_samples(batch32))
    dev_batch = engine_lib._to_device(arrays, DEV)
    def forward():
        with torch.inference_mode():
            engine.model(dev_batch)

    fwd_ms = time_ms(forward, iters=5, repeats=3)
    dev_ms, by_category = _device_ms(forward, 3)
    probe = serving["probe"]
    ref_model = flagship.visual_bert({"quant": "int8"})
    ref_model.load_state_dict(serving["state"], strict=True)
    ref = cpu_forward(ref_model, batch32[probe])["scores"]
    got = np.asarray(outs[probe]["scores"], np.float32)
    err = float(np.abs(got - ref).max())
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    check(err <= SERVE_ATOL and cos >= SERVE_MIN_COSINE,
          f"VisualBERT int8 vs int8 CPU: max_abs_err {err}, cosine {cos}")
    info = float(np.abs(got - serving["ref_f32"]).max())
    model.cpu()
    torch.cuda.empty_cache()
    check(sum(shapes.values()) == VB_K5, f"K5 shapes {shapes}")
    k5_lines, k5_total = _k5_per_shape(shapes)
    print(f"phase vb-int8: ok VisualBERT-base quant: int8 at bucket 32; "
          f"launches {launches} (exact per forward); one request's scores "
          f"vs the int8 CPU forward (plain versions) max_abs_err "
          f"{err:.4g} cosine {cos:.6f} (bounds {SERVE_ATOL} / "
          f"{SERVE_MIN_COSINE}); vs the f32 CPU forward (information) "
          f"{info:.4g}")
    print(f"  VisualBERT forward alone at bucket 32 on '{card}': int8 "
          f"{fwd_ms:.2f} ms, bf16 {serving['fwd_ms']:.2f} ms (CUDA "
          f"events); int8 device time {dev_ms:.3f} ms (torch.profiler, 3 "
          "forwards): " + "; ".join(
              f"{cat} {ms:.3f} x{cnt:.0f}" for cat, (ms, cnt) in
              sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    print(f"  K5 at the shapes of one VisualBERT int8 forward at bucket 32 "
          f"(device_ms, each against its plain version): {k5_total:.4f} ms "
          "per forward (launches x ms)")
    print("\n".join(k5_lines))
    return launches, k5_total


@contextlib.contextmanager
def _k5_shapes():
    """Records K5's calls by (M, K, N, output dtype) while active."""
    shapes, kernel = {}, Q.dequant_gemm

    def recording(x8, w8, xs, ws, bias, out_dtype=torch.float32):
        key = (x8.shape[0], x8.shape[1], w8.shape[0], out_dtype)
        shapes[key] = shapes.get(key, 0) + 1
        Q.dequant_gemm = kernel  # the wrapper counts on its own name
        try:
            return kernel(x8, w8, xs, ws, bias, out_dtype)
        finally:
            Q.dequant_gemm = recording

    Q.dequant_gemm = recording
    try:
        yield shapes
    finally:
        Q.dequant_gemm = kernel


def _k5_per_shape(shapes):
    """K5 at each recorded shape: checked against its plain version, timed
    by device_ms beside torch._int_mm; (report lines, ms per forward)."""
    g = torch.Generator(device=DEV).manual_seed(5)
    lines, total = [], 0.0
    for (m, k, n, dt), count in sorted(shapes.items(), key=lambda kv: (
            -kv[1], kv[0][:3])):
        x8, w8, xs, ws, bias = _k5_operands(m, k, n, g)
        out = Q.dequant_gemm(x8, w8, xs, ws, bias, dt)
        torch.cuda.synchronize()
        err = k5_error(out, x8, w8, xs, ws, bias, dt, f"K5 {m}x{k}x{n} {dt}")
        kern = device_ms(lambda: Q.dequant_gemm(x8, w8, xs, ws, bias, dt))
        w8t = w8.t()
        lib = (device_ms(lambda: torch._int_mm(x8, w8t)) if m > 16
               else None)
        b_ms, b_by = bound(_nbytes(x8, w8, xs, ws, bias, out),
                           2 * m * n * k, torch.int8)
        total += count * kern
        lines.append(
            f"    M={m} K={k} N={n} -> {str(dt)[6:]} x{count}: max_abs_err "
            f"{err:.3g}; kernel {kern:.4f} ms "
            f"({2e-9 * m * n * k / kern:.1f} TOP/s), torch._int_mm "
            f"{'n/a' if lib is None else f'{lib:.4f}'}, bound {b_ms:.4f} by "
            f"{b_by}; {Q.k5_tile(m, n)}-wide tiles")
    return lines, total


SOURCES = {  # name -> (route, source, the TPU kernel it replaces)
    "flash_attention_fwd": ("cuda",
                            "mmf_tpu_torch/ops/csrc/flash_attention_fwd.cu",
                            "mmf_tpu/ops/attention.py:114"),
    "flash_attention_fwd_stats": (
        "cuda", "mmf_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "mmf_tpu/ops/attention.py:114"),
    "flash_attention_fwd_raw": (
        "cuda", "mmf_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "mmf_tpu/ops/attention.py:168"),
    "flash_attention_bwd_dq": (
        "cuda", "mmf_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "mmf_tpu/ops/attention.py:372"),
    "flash_attention_bwd_dkv": (
        "cuda", "mmf_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "mmf_tpu/ops/attention.py:419"),
    "layer_norm": ("triton", "mmf_tpu_torch/ops/layernorm_triton.py",
                   "mmf_tpu/ops/layernorm.py:81"),
    # JAX's backward is the VJP of _ln_reference (no Pallas kernel)
    "layer_norm_bwd": ("cuda", "mmf_tpu_torch/ops/csrc/layer_norm_bwd.cu",
                       "mmf_tpu/ops/layernorm.py:157"),
    "int8_dequant_gemm": ("cuda", "mmf_tpu_torch/ops/csrc/int8_gemm.cu",
                          "mmf_tpu/ops/quant.py:71"),
}


LIBRARY = {  # name -> the PyTorch call timed as its library_ms
    "flash_attention_fwd": "F.scaled_dot_product_attention",
    "flash_attention_fwd_stats": (
        "aten._scaled_dot_product_efficient_attention with "
        "compute_log_sumexp (output and the rows' m + log l)"),
    "flash_attention_fwd_raw": (
        "none: no PyTorch call returns the unnormalized state (K1-raw's "
        "ms is device_ms)"),
    "flash_attention_bwd_dq": (
        "F.scaled_dot_product_attention backward: dq, dk, dv together "
        "(K2 + K3 combined); K2, K3 and it timed by device_ms, CUDA "
        "events over back-to-back calls beside them"),
    "flash_attention_bwd_dkv": (
        "F.scaled_dot_product_attention backward: dq, dk, dv together "
        "(K2 + K3 combined); K2, K3 and it timed by device_ms, CUDA "
        "events over back-to-back calls beside them"),
    "layer_norm": ("F.layer_norm after the residual add, weights in bf16 "
                   "(device_ms over rotating input sets, as K4's ms); "
                   "every form under 'forms'"),
    "layer_norm_bwd": ("F.layer_norm's backward (dx, dweight, dbias) after "
                       "the residual add, weights in bf16 (device_ms over "
                       "rotating input sets, as K4-bwd's ms); plain_vjp_ms "
                       "is the backward before K4-bwd, autograd's VJP of "
                       "the plain forward; every form under 'forms'"),
    "int8_dequant_gemm": ("torch._int_mm on the same operands: the int32 "
                          "product alone, no dequantising epilogue (K5's "
                          "times are device_ms: calls queued behind a "
                          "spin kernel)"),
}


def main():
    card = card_line()
    phase_build(card)
    results = phase_kernels(card)
    served, serving = phase_serving(card)
    trained = phase_training(card)
    mmbt = phase_mmbt(card)
    vb_int8, k5_vb_ms = phase_vb_int8(card, serving)
    results["int8_dequant_gemm"]["vb_int8_forward_ms"] = k5_vb_ms
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            # launches on the paths that run the kernel: serving (K1
            # inference form, K4), training (K1 stats form, K2, K3, K4,
            # K4-bwd),
            # MMBT-grid at batch 1 (K1, K4, K5 under int8) and VisualBERT
            # under int8 (K1, K4, K5)
            "launches": (served[name] + trained[name] + mmbt[name]
                         + vb_int8[name]),
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # one PyTorch call computing the same function: LIBRARY says
            # which
            "library_ms": r["library_ms"], "library": LIBRARY[name],
            **{k: r[k] for k in ("events_ms", "library_events_ms", "host_us",
                                 "vb_int8_forward_ms", "plain_vjp_ms",
                                 "forms") if k in r},
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
