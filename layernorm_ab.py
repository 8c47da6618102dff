"""K4-bwd, the LayerNorm backward, of this checkout timed beside other
trees', in one process on one NVIDIA card.

    python3 layernorm_ab.py [--other DIR ...] [--rounds N] [--out FILE]

Each DIR holds another copy of the repo (for example the parent commit,
unpacked with ``git archive``): its ``mmf_tpu_torch/ops/csrc/
layer_norm_bwd.cu`` is built with nvcc into a temporary directory
(``attention_ab._nvcc``), and its own wrapper module
(``mmf_tpu_torch/ops/layernorm.py``, loaded under another name) is made
to call that library. Every arm, this checkout's included, is timed
through its own wrapper, so that each arm's host path is its own too.

At each shape (``SHAPES``: the (rows, hidden, dtype, residual) at which
the main paths' training steps run K4-bwd, as chip_smoke.py's
ln-bwd-shapes phase records them) the script records whether each arm's dx,
dscale and dbias equal this checkout's bit for bit (chip_smoke.py holds
this checkout's against the plain backward), then times every arm in
turns (this checkout, the other trees, then back in reverse order;
``--rounds`` passes): device ms by ``chip_smoke.device_ms`` over input
sets rotated so that every call reads device memory
(``chip_smoke.ROTATE_BYTES``) and host us a call by
``chip_smoke.host_us``, beside F.layer_norm's backward and the byte
bound. torch.profiler then splits one arm's calls by device kernel:
launches and us a call of each. It prints each arm's best and worst time
over the passes and ptxas' registers and spills of each arm's kernels.
The JSON of it all goes to ``--out`` (``build/layernorm_ab.json`` by
default). Needs one card and nvcc; fails without them.
"""

import argparse
import ctypes
import importlib.util
import json
import math
import os
import re
import sys
import tempfile
import threading
import time

import torch

import chip_smoke as C
from attention_ab import _nvcc, arm_names
from mmf_tpu_torch.ops import _build
from mmf_tpu_torch.ops import layernorm as L

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("mmf_tpu_torch", "ops", "csrc")
NAME = "layer_norm_bwd"

# (rows, hidden, dtype, residual): every shape at which the main paths'
# optimizer steps ran K4-bwd in chip_smoke.py (its ln-bwd-shapes phase on
# an H100): the trunks' LayerNorms (VisualBERT 14592 = 64 x 228 tokens,
# ViLBERT's text 8192 and regions 6400 at 1024, MMFT 7296, MMBT 4192,
# ViLT 39488 in f32, UNITER, VinVL, LXMERT and the Hateful Memes BERT in
# f32, M4C 23296, LXMERT's masked VQA2 1280 and 2304), and the heads',
# embeddings' and encoders' (24-5000 rows, H = 1536)
SHAPES = [(rows, hidden, dtype, res) for hidden, dtype, rows, res in [
    (768, "bfloat16", 24, False), (768, "bfloat16", 64, False),
    (768, "bfloat16", 96, False), (768, "bfloat16", 1024, False),
    (768, "bfloat16", 1048, True), (768, "bfloat16", 4096, False),
    (768, "bfloat16", 4192, True), (768, "bfloat16", 7296, True),
    (768, "bfloat16", 8192, False), (768, "bfloat16", 8192, True),
    (768, "bfloat16", 14592, False), (768, "bfloat16", 14592, True),
    (768, "float32", 64, False), (768, "float32", 640, False),
    (768, "float32", 896, False), (768, "float32", 1280, False),
    (768, "float32", 1280, True), (768, "float32", 1536, False),
    (768, "float32", 2304, False), (768, "float32", 2304, True),
    (768, "float32", 2560, False), (768, "float32", 2560, True),
    (768, "float32", 4480, False), (768, "float32", 5000, False),
    (768, "float32", 6400, False), (768, "float32", 6400, True),
    (768, "float32", 7296, False), (768, "float32", 8192, False),
    (768, "float32", 8192, True), (768, "float32", 9872, False),
    (768, "float32", 10880, True), (768, "float32", 12800, False),
    (768, "float32", 14592, False), (768, "float32", 14592, True),
    (768, "float32", 16384, False), (768, "float32", 16384, True),
    (768, "float32", 19744, False), (768, "float32", 23296, True),
    (768, "float32", 39488, False), (1024, "bfloat16", 64, False),
    (1024, "bfloat16", 6400, False), (1024, "bfloat16", 6400, True),
    (1024, "float32", 6400, False), (1536, "float32", 64, False)]]


def load_arm(tree, lib_path, log, name):
    """``tree``'s own layernorm module, loaded under another name, its
    ``_bwd_lib`` bound to the library at ``lib_path``."""
    spec = importlib.util.spec_from_file_location(
        f"layernorm_{re.sub(r'\W', '_', name)}",
        os.path.join(tree, "mmf_tpu_torch", "ops", "layernorm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(lib_path)
    info = {"build_s": 0.0, "path": lib_path, "ptxas": log}
    saved = _build.load_library
    # the module's _bwd_lib imports load_library at its call and types
    # the library's entry points as its own C signatures say
    _build.load_library = lambda *_: (lib, info)
    try:
        typed = mod._bwd_lib()
    finally:
        _build.load_library = saved
    mod._bwd_lib = lambda: typed
    return mod


def build_arms(others, tmp):
    """{arm: (wrapper module, ptxas log)}: this checkout's through the
    port's own build, each other tree's by nvcc, all started together."""
    names = arm_names(others)
    built, errors = {}, []

    def run(arm, tree):
        try:
            if tree is None:
                built[arm] = L.build_layer_norm_bwd()["ptxas"]
            else:
                built[arm] = _nvcc(os.path.join(tree, CSRC), NAME,
                                   os.path.join(tmp, arm))
        except BaseException as e:  # reported on the main thread
            errors.append((arm, e))

    jobs = [("this", None)] + list(zip(names, others))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"layernorm_ab: built {len(jobs)} libraries in parallel in "
          f"{time.perf_counter() - t0:.1f}s")
    for arm, e in errors:
        print(f"layernorm_ab: {arm} did not build: {e}")
    if errors:
        raise RuntimeError("a library did not build")
    arms = {"this": (L, built["this"])}
    for arm, tree in zip(names, others):
        path, log = built[arm]
        arms[arm] = (load_arm(tree, path, log, arm), log)
    return arms


def kernel_split(mod, call, n=10):
    """{device kernel: (launches a call, us a call)} of ``n`` calls by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(ln_bwd_\w+)(<[^>]*>)?", e.key)
        key = m.group(0).replace(" ", "") if m else e.key[:60]
        us = (getattr(e, "self_device_time_total", None)
              or e.self_cuda_time_total) / n
        launches, total = out.get(key, (0.0, 0.0))
        out[key] = (launches + e.count / n, total + us)
    return out


def shape_sets(g, rows, hidden, dt, residual):
    """Rotating input sets of ``rows`` x ``hidden`` (x, residual or None,
    dy), at least chip_smoke.ROTATE_BYTES of what a call reads."""
    elt = torch.empty((), dtype=dt).element_size()
    per_call = (3 if residual else 2) * rows * hidden * elt
    n = max(3, math.ceil(C.ROTATE_BYTES / per_call))
    pool = [torch.randn(1, n * rows, hidden, device=C.DEV,
                        generator=g).to(dt) for _ in range(3)]
    return [(x, r if residual else None, dy)
            for x, r, dy in C._ln_sets(pool, rows, per_call)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another copy of the repo (may be repeated)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "layernorm_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("layernorm_ab: torch.cuda.is_available() is False; this "
                 "run needs an NVIDIA card")
    card = C.card_line()
    arms = build_arms(args.other, tempfile.mkdtemp(prefix="layernorm_ab_"))
    order = list(arms)
    print(f"layernorm_ab on '{card}': arms {order}")
    for arm in order:
        rows = [k for k in C.ptxas_report(arms[arm][1]) if "ln_bwd" in k[0]]
        print(f"  {arm} ptxas: " + "; ".join(
            f"{n} {r} regs, {sp} B spills, {sm} B static smem"
            for n, r, sp, sm in rows))
    g = torch.Generator(device=C.DEV).manual_seed(18)
    report = {"card": card, "arms": dict(zip(order, ["."] + args.other)),
              "shapes": {}}
    for rows, hidden, dtype, residual in SHAPES:
        dt = getattr(torch, dtype)
        form = (f"{dtype} [{rows}, {hidden}] "
                f"{'residual' if residual else 'no residual'}")
        sets = shape_sets(g, rows, hidden, dt, residual)
        w = 1.0 + 0.1 * torch.randn(hidden, device=C.DEV, generator=g)
        bb = 0.1 * torch.randn(hidden, device=C.DEV, generator=g)
        x, res, dy = sets[0]
        mine = L.layer_norm_backward_kernel(x, w, dy, res)
        same, split = {}, {}
        for arm in order:
            mod = arms[arm][0]
            got = mod.layer_norm_backward_kernel(x, w, dy, res)
            torch.cuda.synchronize()
            same[arm] = [bool(torch.equal(a, b)) for a, b in zip(got, mine)]
            split[arm] = kernel_split(
                mod, lambda: mod.layer_norm_backward_kernel(x, w, dy, res))
        del mine, got
        lib = [C._ln_library_backward(x_, r_, w, bb, dy_)
               for x_, r_, dy_ in sets]
        ms = {arm: [] for arm in order}
        us = {arm: [] for arm in order}
        lib_ms = []
        for r in range(args.rounds):
            for arm in (order if r % 2 == 0 else order[::-1]):
                mod = arms[arm][0]
                ms[arm].append(C.device_ms(C.rotating(
                    lambda x_, r_, dy_: mod.layer_norm_backward_kernel(
                        x_, w, dy_, r_), sets)))
                us[arm].append(C.host_us(
                    lambda: mod.layer_norm_backward_kernel(x, w, dy, res),
                    iters=30))
            lib_ms.append(C.device_ms(C.rotating(
                lambda f_: f_(), [(f_,) for f_ in lib])))
        out = L.layer_norm_backward_kernel(x, w, dy, res)
        bound_ms, bound_by = C.bound(C._nbytes(x, res, w, dy, *out),
                                     10 * x.numel(), dt)
        report["shapes"][form] = {
            "rows": rows, "hidden": hidden, "dtype": dtype,
            "residual": residual, "sets": len(sets),
            "equal_to_this": same, "ms": ms, "host_us": us,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "kernels": split}
        print(f"  {form} ({len(sets)} rotating sets): F.layer_norm "
              f"backward {min(lib_ms):.4f}-{max(lib_ms):.4f} ms, bound "
              f"{bound_ms:.4f} by {bound_by}")
        for arm in order:
            t, u = ms[arm], us[arm]
            print(f"    {arm}: {min(t):.4f}-{max(t):.4f} ms "
                  f"({100 * bound_ms / min(t):.0f}% of the bound), host "
                  f"{min(u):.1f}-{max(u):.1f} us; device kernels a call: "
                  + ", ".join(f"{k} x{n:g} {v:.2f} us"
                              for k, (n, v) in split[arm].items())
                  + "; bit-equal to this (dx, dscale, dbias): "
                  + ",".join(str(e) for e in same[arm]))
        del sets, lib, out, x, res, dy
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"layernorm_ab: ok; {args.out}")
    print(C.card_line())


if __name__ == "__main__":
    main()
