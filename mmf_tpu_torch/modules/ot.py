"""Optimal transport (IPOT) for the word-region alignment head.

Port of ``mmf_tpu/modules/ot.py``: a fixed number of inexact proximal
point iterations; the transport plan carries no gradient (the reference
computes it under ``no_grad``), the distance does through the cost.
"""

from __future__ import annotations

import torch


def cost_matrix_cosine(x, y, eps: float = 1e-5):
    """Pairwise cosine distance [B, Lx, D], [B, Ly, D] -> [B, Lx, Ly]."""
    x_norm = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                             min=eps)
    y_norm = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True),
                             min=eps)
    return 1.0 - torch.einsum("bmd,bnd->bmn", x_norm, y_norm)


def trace(x):
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def ipot(C, x_len, x_pad, y_len, y_pad, joint_pad, beta, iteration, k):
    """Inexact proximal point OT (reference ot.py:38-78). C [B, M, N];
    x_len [B]; x_pad [B, M] bool; y_* likewise."""
    b, m, n = C.shape
    sigma = torch.ones((b, m), dtype=C.dtype, device=C.device) / x_len[:,
                                                                       None]
    T = torch.ones((b, n, m), dtype=C.dtype, device=C.device)
    A = torch.exp(-C.transpose(1, 2) / beta)
    zero = torch.zeros((), dtype=C.dtype, device=C.device)
    sigma = torch.where(x_pad, zero, sigma)
    joint_pad_t = joint_pad.transpose(1, 2)
    T = torch.where(joint_pad_t, zero, T)
    A = torch.where(joint_pad_t, zero, A)
    x_len_b = x_len[:, None, None]
    y_len_b = y_len[:, None, None]
    x_mask = (x_pad.to(C.dtype) * 1e4)[:, None, :]
    y_mask = (y_pad.to(C.dtype) * 1e4)[:, None, :]
    for _ in range(iteration):
        Q = A * T  # [b, n, m]
        sigma_c = sigma.reshape(b, m, 1)
        delta = torch.zeros((b, 1, n), dtype=C.dtype, device=C.device)
        for _ in range(k):
            delta = 1.0 / (y_len_b * torch.matmul(Q, sigma_c).reshape(
                b, 1, n) + y_mask)
            sigma_c = (1.0 / (x_len_b * torch.matmul(delta, Q) + x_mask)
                       ).transpose(1, 2)
        T = delta.reshape(b, n, 1) * Q * sigma_c.transpose(1, 2)
        sigma = sigma_c[:, :, 0]
    return torch.where(joint_pad_t, zero, T)


def optimal_transport_dist(txt_emb, img_emb, txt_pad, img_pad, beta=0.5,
                           iteration=50, k=1):
    """Wasserstein distance between token sets (reference ot.py:81-102)."""
    cost = cost_matrix_cosine(txt_emb, img_emb)
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = torch.where(joint_pad, torch.zeros_like(cost), cost)
    txt_len = (txt_pad.shape[1] - txt_pad.sum(dim=1)).to(cost.dtype)
    img_len = (img_pad.shape[1] - img_pad.sum(dim=1)).to(cost.dtype)
    with torch.no_grad():
        T = ipot(cost.detach(), txt_len, txt_pad, img_len, img_pad,
                 joint_pad, beta, iteration, k)
    return trace(torch.matmul(cost, T))
