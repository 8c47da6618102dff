"""The attention kernels of this checkout timed beside other trees', in
one process on one NVIDIA card.

    python3 attention_ab.py [--other DIR ...] [--shapes LABELS]
                            [--vilbert-step] [--rounds N] [--out FILE]

Each DIR holds another copy of the repo (for example the parent commit,
unpacked with ``git archive``): its ``mmf_tpu_torch/ops/csrc`` sources are
built with nvcc into a temporary directory and loaded beside this
checkout's kernels. Every build ("arm", named by its directory) goes
through the port's own wrappers (``mmf_tpu_torch.ops.attention``), whose
libraries are swapped in turn.

At each shape (``SHAPES``) the script records whether each arm's K1
(inference and stats forms), K2 and K3 outputs equal this checkout's bit
for bit (chip_smoke.py holds this checkout's against the plain
versions), then times every arm's kernels in turns (this checkout, the
other trees, then back in reverse order; ``--rounds`` passes): device ms
by ``chip_smoke.device_ms`` and host µs a call by ``chip_smoke.host_us``,
beside SDPA (forward, forward with the logsumexp, backward). It prints
each kernel's best and worst time over the passes, ptxas' registers and
spills of each arm's flash kernels, and the blocks an SM of this
checkout's bf16 K1 and K2. With ``--vilbert-step`` it also runs
ViLBERT's B=64 training step through each arm's kernels: device ms a
step and wall ms a step. The JSON of it all goes to ``--out``
(``build/attention_ab.json`` by default). Needs one card and nvcc;
fails without them.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

import chip_smoke as C
from mmf_tpu_torch.ops import _build
from mmf_tpu_torch.ops import attention as A

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("mmf_tpu_torch", "ops", "csrc")
LIBS = ("flash_attention_fwd", "flash_attention_bwd")

# (label, B, H, Sq, Skv, D): ViLBERT's three D = 128 calls at
# B = 64 and its bucket-8 text-queries call, the VisualBERT main path, MMFT
# (training batch and serving bucket), MMBT, and ViLT in f32
SHAPES = [
    ("vilbert image 100x100", 64, 8, 100, 100, 128),
    ("vilbert text 128x100", 64, 8, 128, 100, 128),
    ("vilbert region 100x128", 64, 8, 100, 128, 128),
    ("vilbert bucket 8", 8, 8, 128, 100, 128),
    ("main path", 64, 12, 228, 228, 64),
    ("mmft", 64, 12, 114, 114, 64),
    ("mmft bucket 32", 32, 12, 114, 114, 64),
    ("mmbt", 32, 12, 131, 131, 64),
    ("vilt f32", 64, 12, 617, 617, 64),
]

KERNELS = ("K1", "K1-stats", "K2", "K3")


def _nvcc(src_dir, name, out_dir):
    """Builds csrc/<name>.cu of ``src_dir`` into ``out_dir``; returns
    (library path, nvcc's log)."""
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
           os.path.join(src_dir, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir}/{name}.cu:\n{log}")
    return lib, log


def _typed(path, like):
    """The library at ``path`` with the entry points' argument types of
    this checkout's ``like`` (same C signatures)."""
    lib = ctypes.CDLL(path)
    for fn in ("mmf_flash_attention_fwd", "mmf_flash_attention_fwd_raw",
               "mmf_flash_attention_bwd_dq", "mmf_flash_attention_bwd_dkv",
               "mmf_cuda_error_string"):
        if hasattr(like, fn) and hasattr(lib, fn):
            getattr(lib, fn).argtypes = getattr(like, fn).argtypes
            getattr(lib, fn).restype = getattr(like, fn).restype
    lib._mmf_typed = True
    return lib


def arm_names(others):
    """A unique arm name for each other tree: its directory's name, with
    a count appended where two share one."""
    names = []
    for d in others:
        base = os.path.basename(os.path.normpath(d)) or "other"
        name, n = base, 1
        while name in names or name == "this":
            n += 1
            name = f"{base}-{n}"
        names.append(name)
    return names


def build_arms(others, tmp):
    """{arm: {"fwd": (lib, info), "bwd": (lib, info), "ptxas": log}}:
    this checkout's libraries through the port's own build, each other
    tree's by nvcc, all started together."""
    names = arm_names(others)
    jobs = [("this", name, None) for name in LIBS]  # (arm, lib, sources)
    for arm, d in zip(names, others):
        for name in LIBS:
            jobs.append((arm, name, os.path.join(d, CSRC)))
    built, errors, mine = {}, [], {}

    def run(arm, name, src):
        try:
            if arm == "this":  # the port's own build of this checkout
                key = "fwd" if name == LIBS[0] else "bwd"
                mine[key] = (A._fwd_lib if key == "fwd" else A._bwd_lib)()
            else:
                built[(arm, name)] = _nvcc(src, name,
                                           os.path.join(tmp, arm))
        except BaseException as e:  # reported on the main thread
            errors.append((arm, name, e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"attention_ab: built {len(jobs)} libraries in parallel in "
          f"{time.perf_counter() - t0:.1f}s")
    for arm, name, e in errors:
        print(f"attention_ab: {arm} {name} did not build: {e}")
    if errors:
        raise RuntimeError("a library did not build")
    arms = {"this": dict(mine, ptxas=mine["fwd"][1]["ptxas"]
                         + mine["bwd"][1]["ptxas"])}
    for arm in names:
        libs, logs = {}, ""
        for key, name in zip(("fwd", "bwd"), LIBS):
            path, log = built[(arm, name)]
            libs[key] = (_typed(path, mine[key][0]), {"ptxas": log})
            logs += log
        arms[arm] = dict(libs, ptxas=logs)
    return arms


class use:
    """Routes the port's attention wrappers to an arm's libraries."""

    def __init__(self, arm):
        self.arm = arm

    def __enter__(self):
        self.saved = A._fwd_lib, A._bwd_lib
        A._fwd_lib = lambda: self.arm["fwd"]
        A._bwd_lib = lambda: self.arm["bwd"]

    def __exit__(self, *exc):
        A._fwd_lib, A._bwd_lib = self.saved


def inputs(label, b, h, sq, skv, d, g):
    if label.startswith("mmft"):
        return C._mmft_attention_inputs(b, g)
    if label == "mmbt":
        return C._hm_attention_inputs(b, sq, 3, torch.bfloat16, g)
    if label.startswith("vilt"):
        return C._vilt_attention_inputs(b, g)
    return C._attention_inputs(b, sq, skv, torch.bfloat16, g, h, d)


def outputs(q, k, v, bias, dout):
    out = A.flash_attention(q, k, v, bias)
    out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
    dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
    torch.cuda.synchronize()
    return {"out": out, "out_s": out_s, "m": m, "l": l, "dq": dq,
            "delta": delta, "dk": dk, "dv": dv}


def vilbert_step(arms, rounds, walls=4):
    """{arm: [(device ms, attention ms, wall ms), one per pass]}: ViLBERT's
    B=64 training step (chip_smoke.py's vilbert-training configuration)
    through each arm's kernels in turns; device time by torch.profiler
    over 2 steps, wall time the best of ``walls`` steps, each waited
    for."""
    cfg = C._vilbert_config()
    host_batch = C.flagship.vilbert_train_batch(C.TRAIN_B, C.SEQ, C.REGIONS,
                                                C.VDIM, seed=0)
    model = C.flagship.vqa2_vilbert(cfg, example=host_batch)
    model.init_weights(torch.Generator().manual_seed(0))
    state, step = C.flagship.vqa2_trainer(model, cfg, seed=0)
    batch = C.train_state._to_device(host_batch, C.DEV)
    box = [state]

    def one():
        box[0], _ = step(box[0], batch)

    order = list(arms)
    res = {arm: [] for arm in order}
    for r in range(rounds):
        for arm in (order if r % 2 == 0 else order[::-1]):
            with use(arms[arm]):
                one()
                torch.cuda.synchronize()
                ms, cats = C._device_ms(one, 2)
                wall = []
                for _ in range(walls):
                    t0 = time.perf_counter()
                    one()
                    torch.cuda.synchronize()
                    wall.append(1e3 * (time.perf_counter() - t0))
            att = sum(v[0] for c, v in cats.items() if "ttention" in c)
            res[arm].append((ms, att, min(wall)))
    del box, state, step, model
    torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another copy of the repo (may be repeated)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shapes", help="comma-separated labels (default all)")
    ap.add_argument("--vilbert-step", action="store_true",
                    help="also time ViLBERT's B=64 training step through "
                    "each arm's kernels")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "attention_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attention_ab: torch.cuda.is_available() is False; this "
                 "run needs an NVIDIA card")
    card = C.card_line()
    tmp = tempfile.mkdtemp(prefix="attention_ab_")
    arms = build_arms(args.other, tmp)
    order = list(arms)
    print(f"attention_ab on '{card}': arms {order}")
    for arm in order:
        rows = [k for k in C.ptxas_report(arms[arm]["ptxas"])
                if "sm90" in k[0] or "tf32" in k[0]]
        print(f"  {arm} ptxas: " + "; ".join(
            f"{n} {r} regs, {sp} B spills" for n, r, sp, _ in rows))
    blocks = C.attention_blocks()
    print("  this checkout's bf16 blocks: " + "; ".join(
        f"{kid} D={d} {form}{' elem' if elem else ''} {sm} B {n}/SM"
        for kid, d, form, elem, sm, n in blocks))
    shapes = SHAPES if not args.shapes else [
        s for s in SHAPES if s[0] in args.shapes.split(",")]
    g = torch.Generator(device=C.DEV).manual_seed(15)
    report = {"card": card, "arms": dict(zip(order, ["."] + args.other)),
              "shapes": {}}
    for label, b, h, sq, skv, d in shapes:
        q, k, v, bias, dout = inputs(label, b, h, sq, skv, d, g)
        dt = q.dtype
        same, keep = {}, {}
        for arm in order:
            with use(arms[arm]):
                keep[arm] = outputs(q, k, v, bias, dout)
            same[arm] = {n: bool(torch.equal(t, keep["this"][n]))
                         for n, t in keep[arm].items()}
        del keep
        out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
        dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l,
                                             dout)
        calls = {
            "K1": lambda: A.flash_attention(q, k, v, bias),
            "K1-stats": lambda: A.flash_attention_with_stats(q, k, v, bias),
            "K2": lambda: A.flash_attention_bwd_dq(q, k, v, bias, out_s, m,
                                                   l, dout),
            "K3": lambda: A.flash_attention_bwd_dkv(q, k, v, bias, dout, m,
                                                    l, delta),
        }
        sdpa = {
            "fwd": lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bias),
            "fwd+lse": C._sdpa_with_lse(q, k, v, bias),
            "bwd": C._sdpa_backward(q, k, v, bias, dout),
        }
        ms = {arm: {n: [] for n in KERNELS} for arm in order}
        us = {arm: {n: [] for n in KERNELS} for arm in order}
        lib = {n: [] for n in sdpa}
        for r in range(args.rounds):
            for arm in (order if r % 2 == 0 else order[::-1]):
                with use(arms[arm]):
                    for n in KERNELS:
                        ms[arm][n].append(C.device_ms(calls[n]))
                        us[arm][n].append(C.host_us(calls[n], iters=20))
            for n, fn in sdpa.items():
                lib[n].append(C.device_ms(fn, iters=10 if n == "bwd"
                                          else 20))
        report["shapes"][label] = {
            "shape": [b, h, sq, skv, d], "dtype": str(dt)[6:],
            "equal_to_this": same, "ms": ms, "host_us": us, "sdpa_ms": lib}
        print(f"  {label} [{b}, {h}, {sq}, {skv}, {d}] {str(dt)[6:]}: sdpa "
              + ", ".join(f"{n} {min(t):.4f}-{max(t):.4f}"
                          for n, t in lib.items()))
        for arm in order:
            t, u = ms[arm], us[arm]
            print(f"    {arm}: " + ", ".join(
                f"{n} {min(t[n]):.4f}-{max(t[n]):.4f}" for n in KERNELS)
                + f"; K2+K3 {min(t['K2']) + min(t['K3']):.4f}; host us "
                + ", ".join(f"{n} {min(u[n]):.1f}-{max(u[n]):.1f}"
                            for n in KERNELS)
                + "; bit-equal to this: " + ",".join(
                    n for n, eq in same[arm].items() if eq))
        del q, k, v, bias, dout, out_s, m, l, dq, delta, calls, sdpa
        torch.cuda.empty_cache()
    if args.vilbert_step:
        steps = vilbert_step(arms, args.rounds)
        report["vilbert_step"] = steps
        print("  ViLBERT B=64 training step per pass: device ms a step "
              "(torch.profiler, 2 steps; of it the attention kernels), "
              "wall ms (best of 4): " + "; ".join(f"{arm} " + ", ".join(
                  f"{ms:.2f} ({att:.2f}), {wall:.2f}"
                  for ms, att, wall in v) for arm, v in steps.items()))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"attention_ab: ok; {args.out}")
    print(C.card_line())


if __name__ == "__main__":
    main()
