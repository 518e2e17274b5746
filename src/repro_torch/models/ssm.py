"""Mamba2 (SSD — state-space duality) mixer block.

Implements the chunked SSD algorithm (Dao & Gu 2024, arXiv:2405.21060):
the selective state-space recurrence

    h_t = a_t · h_t-1 + dt_t · B_t ⊗ x_t          (per head, a_t = exp(dt·A))
    y_t = C_t · h_t + D · x_t

is evaluated as (i) an intra-chunk quadratic, attention-like form over
(Q, Q) chunk tiles, plus (ii) an inter-chunk scan of the (H, N, P) chunk
states: a loop of S/Q sequential steps, in fp32.

Projections are split per stream (z, x, B, C, dt) instead of one fused
in_proj: mathematically identical, and the parameter tree is the JAX
package's.

The decode path is the O(1)-per-token recurrence over a persistent
(B, H, N, P) state plus a (K-1)-deep depthwise-conv ring buffer: the
state's size does not depend on the context's length.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _init, rmsnorm

Params = Dict[str, Any]


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim, d_state)."""
    di = cfg.ssm_expand * cfg.d_model
    pd = cfg.ssm_headdim
    assert di % pd == 0
    return di, di // pd, pd, cfg.ssm_state


def init_ssm(gen, cfg: ArchConfig, dtype, device,
             lead: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    di, h, pdim, n = ssm_dims(cfg)
    s = 1.0 / math.sqrt(d)
    kc = cfg.ssm_conv

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=device))
    return {
        "in_z": _init(gen, lead + (d, di), s, dtype, device),
        "in_x": _init(gen, lead + (d, di), s, dtype, device),
        "in_b": _init(gen, lead + (d, n), s, dtype, device),
        "in_c": _init(gen, lead + (d, n), s, dtype, device),
        "in_dt": _init(gen, lead + (d, h), s, dtype, device),
        "conv_x": _init(gen, lead + (kc, di), 0.5, dtype, device),
        "conv_b": _init(gen, lead + (kc, n), 0.5, dtype, device),
        "conv_c": _init(gen, lead + (kc, n), 0.5, dtype, device),
        "conv_bias_x": zeros(di),
        "conv_bias_b": zeros(n),
        "conv_bias_c": zeros(n),
        "dt_bias": zeros(h, dt=torch.float32),
        "a_log": a_log.expand(lead + (h,)).clone(),
        "d_skip": torch.ones(lead + (h,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones(lead + (di,), dtype=dtype, device=device),
        "out_proj": _init(gen, lead + (di, d), 1.0 / math.sqrt(di), dtype,
                          device),
    }


def _causal_conv(w, bias, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (kernel K) via K shifted adds; x (B, S, C)."""
    k = w.shape[0]
    out = x * w[k - 1].to(x.dtype)
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        out = out + shifted * w[k - 1 - i].to(x.dtype)
    return F.silu(out + bias.to(x.dtype))


def _streams(p: Params, x: torch.Tensor, cfg: ArchConfig):
    dt_ = x.dtype
    z = torch.matmul(x, p["in_z"].to(dt_))
    xi = torch.matmul(x, p["in_x"].to(dt_))
    bm = torch.matmul(x, p["in_b"].to(dt_))
    cm = torch.matmul(x, p["in_c"].to(dt_))
    dt = torch.matmul(x, p["in_dt"].to(dt_))
    return z, xi, bm, cm, dt


def ssd_forward(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence SSD (train / prefill).  x (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    di, h, pdim, n = ssm_dims(cfg)
    q = cfg.ssm_chunk
    assert s % q == 0, (s, q)
    nc = s // q
    f32 = torch.float32

    z, xi, bm, cm, dt = _streams(p, x, cfg)
    xi = _causal_conv(p["conv_x"], p["conv_bias_x"], xi)
    bm = _causal_conv(p["conv_b"], p["conv_bias_b"], bm)
    cm = _causal_conv(p["conv_c"], p["conv_bias_c"], cm)
    xs = xi.reshape(b, s, h, pdim)

    dtv = F.softplus(dt.float() + p["dt_bias"])                   # (B,S,H)
    a = -torch.exp(p["a_log"])                                     # (H,)
    log_decay = dtv * a[None, None, :]                             # (B,S,H) ≤ 0

    # chunk views
    xs_c = xs.reshape(b, nc, q, h, pdim)
    b_c = bm.reshape(b, nc, q, n).to(f32)
    c_c = cm.reshape(b, nc, q, n).to(f32)
    ld_c = log_decay.reshape(b, nc, q, h)
    dt_c = dtv.reshape(b, nc, q, h)

    cum = torch.cumsum(ld_c, dim=2)                  # (B,nc,Q,H)
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    ar = torch.arange(q, device=x.device)
    lmask = ar[:, None] >= ar[None, :]
    lmat = torch.exp(torch.where(lmask[None, None, ..., None], li - lj,
                                 -1e30))
    scores = torch.einsum("bcin,bcjn->bcij", c_c, b_c)
    xdt = xs_c.to(f32) * dt_c[..., None]                           # (B,nc,Q,H,P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * lmat,
                           xdt)

    # chunk states: S_c = Σ_j exp(cum_last - cum_j) B_j ⊗ xdt_j -> (B,nc,H,N,P)
    tail_decay = torch.exp(cum[:, :, -1:, :] - cum)                # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjn,bcjhp->bchnp", b_c,
                           tail_decay[..., None] * xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])                      # (B,nc,H)

    # inter-chunk scan: the state entering each chunk
    hprev = torch.zeros((b, h, n, pdim), dtype=f32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_in = torch.stack(h_in, dim=1)                  # (B,nc,H,N,P)

    in_decay = torch.exp(cum)                        # decay chunk-start -> i
    y_inter = torch.einsum("bcin,bchnp->bcihp", c_c, h_in) * \
        in_decay[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, pdim)
    y = y + xs.to(f32) * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)

    # gated RMSNorm + out proj
    y = y * F.silu(z)
    y = rmsnorm({"scale": p["norm_scale"]}, y, cfg.norm_eps)
    return torch.matmul(y, p["out_proj"].to(x.dtype))


# ---------------------------------------------------------------------------
# Decode (O(1) per token)
# ---------------------------------------------------------------------------

def ssm_decode_state(cfg: ArchConfig, batch: int, device,
                     dtype=torch.float32, lead: Tuple[int, ...] = ()):
    di, h, pdim, n = ssm_dims(cfg)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return {
        "h": zeros(batch, h, n, pdim),
        "conv_x": zeros(batch, cfg.ssm_conv - 1, di),
        "conv_b": zeros(batch, cfg.ssm_conv - 1, n),
        "conv_c": zeros(batch, cfg.ssm_conv - 1, n),
    }


def _conv_step(w, bias, buf, cur, dtype):
    """One causal-conv step over ring buffer; returns (out, new_buf)."""
    window = torch.cat([buf, cur[:, None].to(buf.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", window.to(dtype), w.to(dtype))
    return F.silu(out + bias.to(dtype)), window[:, 1:]


def ssd_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               cfg: ArchConfig):
    """x (B, 1, D); returns (y (B,1,D), new_state)."""
    b = x.shape[0]
    di, h, pdim, n = ssm_dims(cfg)
    f32 = torch.float32
    z, xi, bm, cm, dt = _streams(p, x, cfg)

    xo, ncx = _conv_step(p["conv_x"], p["conv_bias_x"], state["conv_x"],
                         xi[:, 0], x.dtype)
    bo, ncb = _conv_step(p["conv_b"], p["conv_bias_b"], state["conv_b"],
                         bm[:, 0], x.dtype)
    co, ncc = _conv_step(p["conv_c"], p["conv_bias_c"], state["conv_c"],
                         cm[:, 0], x.dtype)

    xs = xo.reshape(b, h, pdim).to(f32)
    bv = bo.to(f32)
    cv = co.to(f32)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])                  # (B,H)
    a = torch.exp(dtv * (-torch.exp(p["a_log"]))[None, :])             # (B,H)

    hst = state["h"].to(f32)
    hst = hst * a[..., None, None] + \
        torch.einsum("bn,bhp->bhnp", bv, xs * dtv[..., None])
    y = torch.einsum("bn,bhnp->bhp", cv, hst) + \
        xs * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)

    y = y * F.silu(z)
    y = rmsnorm({"scale": p["norm_scale"]}, y, cfg.norm_eps)
    y = torch.matmul(y, p["out_proj"].to(x.dtype))
    return y, {"h": hst.to(state["h"].dtype), "conv_x": ncx,
               "conv_b": ncb, "conv_c": ncc}
