"""Measure what bounds the f32 attention kernels on the card.

``python -m mmf_tpu_torch.ops.tensor_core_rates`` builds
``ops/csrc/tensor_core_rates.cu`` with ``nvcc`` and runs it: the peak
TFLOP/s of ``mma.sync`` m16n8k8 tf32 (the f32 K2 and K3's route) and
m16n8k16 bf16 at 4 and 8 warps an SM, and of ``wgmma`` m64n64k8 tf32
at 1 to 4 warpgroups an SM. Then it prints the SASS opcode counts of
the f32 K1, K2 and K3 (``cuobjdump``), the instruction mix a tile of
their loop issues. Needs the card and the CUDA toolkit; prints the card's name
and power limit first.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess

from mmf_tpu_torch.ops._build import BUILD_ROOT, CSRC, find_nvcc

# an instruction line's opcode, after its address and any predicate
SASS_OP = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def rates() -> str:
    """Build and run the rate probe; its output."""
    os.makedirs(BUILD_ROOT, exist_ok=True)
    exe = os.path.join(BUILD_ROOT, "tensor_core_rates")
    subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", exe,
                    os.path.join(CSRC, "tensor_core_rates.cu")], check=True)
    return subprocess.run([exe], capture_output=True, text=True,
                          check=True).stdout


def sass_counts(library: str) -> dict:
    """{kernel: Counter of SASS opcodes} for the f32 (split-TF32) kernels
    in ``library``."""
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if "tf32x3" in name:
            out[name] = collections.Counter(
                m.group(1).split(".")[0] for m in SASS_OP.finditer(body))
    return out


def main():
    from mmf_tpu_torch.ops import attention as A

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(rates(), end="")
    for lib in (A._fwd_lib, A._bwd_lib):
        for name, ops in sass_counts(lib()[1]["path"]).items():
            print(f"{name}: {sum(ops.values())} instructions; " + ", ".join(
                f"{op} {n}" for op, n in ops.most_common(12)))


if __name__ == "__main__":
    main()
