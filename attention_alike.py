"""The attention backward over nearly alike values, on the card.

Values whose rows share one random row and differ from it by
``spread`` of its scale (mmf_bert's and ViLBERT's cross-attention reads
another attention's output, rows nearly alike), at ViLBERT's D = 128 and
the main path's D = 64: the largest |error| of dq, dk and dv over the
largest |gradient|, against float64 on the same inputs, for the kernels
(through autograd, ``dot_product_attention``) and, in bf16, for the plain
version on the same bf16 tensors (``mha_reference``); f32's kernels
beside them. The bounds are ``tests/test_torch_cuda_kernels.py``'s
``GRAD_REL``.

    PYTHONPATH=. python3 attention_alike.py     # on the card, ~1 min
"""

import torch

import tests.test_torch_cuda_kernels as K
from mmf_tpu_torch.ops import attention as A

SHAPES = [(2, 8, 128, 100, 128), (2, 12, 128, 100, 64)]


def rel_errors(leaves, ref):
    out = []
    for got, want in zip(leaves, ref):
        w = want.grad.float()
        err = float((got.grad.float() - w).abs().max())
        out.append(err / max(float(w.abs().max()), 1e-6))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("attention_alike: no CUDA card")
    card = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    for b, h, sq, skv, d in SHAPES:
        for spread in (0.01, 1.0):
            rows = {}
            for dtype in (torch.bfloat16, torch.float32):
                g = torch.Generator(device=card).manual_seed(sq + d)
                q, k, _, bias, dout = K._bwd_case(card, dtype, b, h, sq, skv,
                                                  d, seed=5)
                common = torch.randn(b, h, 1, d, device=card, generator=g)
                v = (common + spread * torch.randn(
                    b, h, skv, d, device=card, generator=g)).to(dtype)
                ref = [t.detach().double().requires_grad_()
                       for t in (q, k, v)]
                A.mha_reference(*ref, bias.double()).backward(dout.double())
                routes = ("kernel", "plain") if dtype == torch.bfloat16 \
                    else ("kernel",)
                for route in routes:
                    leaves = [t.detach().clone().requires_grad_()
                              for t in (q, k, v)]
                    attend = A.dot_product_attention if route == "kernel" \
                        else A.mha_reference
                    attend(*leaves, bias).backward(dout)
                    torch.cuda.synchronize()
                    name = str(dtype).split(".")[1]
                    rows[f"{name} {route}"] = rel_errors(leaves, ref)
            print(f"[{b}, {h}, {sq}, {skv}, {d}] spread {spread}: "
                  + "; ".join(f"{label} dq {e[0]:.2e} dk {e[1]:.2e} dv "
                              f"{e[2]:.2e}" for label, e in rows.items())
                + f" (bounds: bf16 {K.GRAD_REL[torch.bfloat16]}, f32 "
                f"{K.GRAD_REL[torch.float32]})", flush=True)


if __name__ == "__main__":
    main()
