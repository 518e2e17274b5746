"""Mixture-of-Experts layer with sort-based capacity dispatch.

Routing is GShard/Switch-style top-k with a static per-expert capacity
``C = ceil(T·k/E · capacity_factor)``, rounded up to a multiple of 8;
tokens over capacity are dropped (their residual path still carries
them).  Dispatch avoids the O(T·E·C) one-hot einsum: assignments are
*stably sorted by expert* and each token's slot is its rank within its
expert's run, found with a search over the sorted expert ids.

Expert compute is one batched product over the (E, C, D) dispatch
buffer; the combine adds each kept assignment's weighted output back to
its token.  DeepSeekMoE extras: ``n_shared`` always-on shared experts
(dense SwiGLU over ``n_shared · d_ff_shared``) added to the routed
output.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _init, init_mlp, mlp

Params = Dict[str, Any]


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def init_moe(gen, cfg: ArchConfig, dtype, device,
             lead: Tuple[int, ...] = ()) -> Params:
    m = cfg.moe
    d = cfg.d_model
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(m.d_ff_expert)
    p: Params = {
        "router": _init(gen, lead + (d, m.n_experts), s_in, torch.float32,
                        device),
        "w_gate": _init(gen, lead + (m.n_experts, d, m.d_ff_expert), s_in,
                        dtype, device),
        "w_up": _init(gen, lead + (m.n_experts, d, m.d_ff_expert), s_in,
                      dtype, device),
        "w_down": _init(gen, lead + (m.n_experts, m.d_ff_expert, d), s_out,
                        dtype, device),
    }
    if m.n_shared:
        p["shared"] = init_mlp(gen, d, m.d_ff_shared * m.n_shared, dtype,
                               device, lead)
    return p


def moe_layer(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D)."""
    m = cfg.moe
    b, s, d = x.shape
    if m.dispatch_blocks and b % m.dispatch_blocks == 0:
        # blocked dispatch: each block of batch rows is routed on its own,
        # with a per-block capacity, so totals stay identical
        nb = m.dispatch_blocks
        xb = x.reshape(nb, (b // nb) * s, d)
        yb = torch.stack([_dispatch_compute(p, xb[i], cfg)
                          for i in range(nb)])
        return yb.reshape(b, s, d)
    return _dispatch_compute(p, x.reshape(b * s, d), cfg).reshape(b, s, d)


def _dispatch_compute(p: Params, xf: torch.Tensor,
                      cfg: ArchConfig) -> torch.Tensor:
    """Route + expert-FFN + combine for a flat (T, D) token block."""
    m = cfg.moe
    t, d = xf.shape
    k = m.top_k
    e = m.n_experts
    cap = moe_capacity(cfg, t)
    dev = xf.device

    # --- routing (fp32) ------------------------------------------------------
    logits = torch.matmul(xf.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)             # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # --- sort-based dispatch --------------------------------------------------
    flat_e = top_e.reshape(t * k)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(t * k)

    se, order = torch.sort(flat_e, stable=True)
    stok = flat_tok[order]
    sw = flat_w[order]
    group_start = torch.searchsorted(
        se, torch.arange(e, device=dev, dtype=se.dtype), side="left")
    rank = torch.arange(t * k, device=dev) - group_start[se]
    keep = rank < cap

    # an assignment past capacity goes to the dump row e, sliced off below
    didx = torch.where(keep, se, e)
    ridx = torch.clamp(rank, 0, cap - 1)
    xe = torch.zeros((e + 1, cap, d), dtype=xf.dtype, device=dev)
    xe[didx, ridx] = xf[stok]
    xe = xe[:e]

    # --- expert FFN --------------------------------------------------------------
    dt = xf.dtype
    g = torch.bmm(xe, p["w_gate"].to(dt))
    u = torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(F.silu(g) * u, p["w_down"].to(dt))

    # --- combine ---------------------------------------------------------------
    contrib = ye[se, ridx] * torch.where(keep, sw, 0.0).to(dt)[:, None]
    yf = torch.zeros((t, d), dtype=dt, device=dev).index_add_(0, stok, contrib)

    if m.n_shared:
        yf = yf + mlp(p["shared"], xf)
    return yf


def aux_load_balance_loss(p: Params, x: torch.Tensor,
                          cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (fraction · probability)."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, -1).reshape(t, m.n_experts)
    top1 = torch.argmax(probs, -1)
    frac = torch.mean(F.one_hot(top1, m.n_experts).float(), 0)
    imp = torch.mean(probs, 0)
    return m.n_experts * torch.sum(frac * imp)
