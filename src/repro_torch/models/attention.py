"""GQA attention with global/local (sliding-window) masking and a static
KV-cache decode path.

Shapes:  x (B, S, D);  q (B, S, H, hd);  k/v (B, S, KV, hd).  GQA groups
the queries as (B, S, KV, H/KV, hd) and broadcasts each KV head across its
H/KV query heads in the einsum: no repeated K/V is materialized.  The
arithmetic is written out (fp32 logits masked with -1e30, softmax cast
back to the activation dtype), as the JAX package writes it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _init, apply_rope, rope_angles

Params = Dict[str, Any]

NEG = -1e30


def init_attention(gen, cfg: ArchConfig, dtype, device,
                   lead: Tuple[int, ...] = ()) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _init(gen, lead + (d, h, hd), s, dtype, device),
        "wk": _init(gen, lead + (d, kv, hd), s, dtype, device),
        "wv": _init(gen, lead + (d, kv, hd), s, dtype, device),
        "wo": _init(gen, lead + (h, hd, d), 1.0 / math.sqrt(h * hd), dtype,
                    device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (kv, hd), dtype=dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk' with the weight cast to the activation dtype."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bshk,hkd->bsd' with the weight cast to the activation dtype."""
    return torch.einsum("bshk,hkd->bsd", o, w.to(o.dtype))


def _qkv(p: Params, x: torch.Tensor, cfg: ArchConfig):
    dt = x.dtype
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _mask(sq: int, skv: int, offset: int, local_window: Optional[int],
          device=None) -> torch.Tensor:
    """(sq, skv) bool mask.  offset = absolute position of query 0 minus
    absolute position of key 0 (0 for self-attn train/prefill)."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    m = kj <= qi
    if local_window is not None:
        m &= kj > qi - local_window
    return m


def _sdpa(q, k, v, mask, cfg: ArchConfig) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H,hd), GQA grouped."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    logits = logits / math.sqrt(cfg.hd)
    logits = torch.where(mask[None, None, None], logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q, k, v, cfg: ArchConfig, local: bool,
                  chunk: int) -> torch.Tensor:
    """Flash-style self-attention: online softmax over KV chunks.

    Never materializes the (Sq, Skv) score tensor: the largest
    intermediate is (B, KV, G, Sq, chunk).  Causal and sliding-window
    masks are applied per chunk from position arithmetic, and chunks
    wholly above the causal diagonal are skipped.  Exact, not
    approximate: it equals the dense path.
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    assert k.shape[1] % chunk == 0, (sq, k.shape, chunk)
    nc = k.shape[1] // chunk
    qg = q.reshape(b, sq, kvh, g, hd)
    scale = 1.0 / math.sqrt(cfg.hd)
    dev = q.device
    q_pos = torch.arange(sq, device=dev)

    m = torch.full((b, kvh, g, sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=q.dtype, device=dev)
    for j in range(nc):
        k_lo = j * chunk
        if k_lo > sq - 1:       # entirely above the causal diagonal
            continue
        kj = k[:, k_lo:k_lo + chunk]
        vj = v[:, k_lo:k_lo + chunk]
        s = torch.einsum("bskgh,btkh->bkgst", qg, kj).float() * scale
        k_pos = k_lo + torch.arange(chunk, device=dev)
        msk = k_pos[None, :] <= q_pos[:, None]          # (sq, chunk)
        if local:
            msk &= k_pos[None, :] > q_pos[:, None] - cfg.sliding_window
        s = torch.where(msk[None, None, None], s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgst,btkh->bskgh", p.to(q.dtype), vj)
        acc = acc * torch.movedim(corr, -1, 1)[..., None].to(acc.dtype) + pv
        m = m_new
    linv = (1.0 / torch.clamp(l, min=1e-30)).to(q.dtype)
    out = acc * torch.movedim(linv, -1, 1)[..., None]
    return out.reshape(b, sq, h, hd)


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig,
              local: bool = False,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over the full sequence (train / prefill)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    pos = positions if positions is not None else \
        torch.arange(s, device=x.device)
    sin, cos = rope_angles(pos, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if cfg.flash_chunk and s % cfg.flash_chunk == 0 and s > cfg.flash_chunk:
        o = _sdpa_chunked(q, k, v, cfg, local, cfg.flash_chunk)
    else:
        mask = _mask(s, s, 0, cfg.sliding_window if local else None,
                     device=x.device)
        o = _sdpa(q, k, v, mask, cfg)
    return _out(o, p["wo"])


def attention_bidir(p: Params, x: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """Bidirectional self-attention (whisper encoder)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    sin, cos = rope_angles(torch.arange(s, device=x.device), cfg.hd,
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
    o = _sdpa(q, k, v, mask, cfg)
    return _out(o, p["wo"])


def init_cross_attention(gen, cfg: ArchConfig, dtype, device,
                         lead: Tuple[int, ...] = ()) -> Params:
    return init_attention(gen, cfg, dtype, device, lead)


def cross_attention(p: Params, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ArchConfig) -> torch.Tensor:
    """x (B,Sq,D) attends over precomputed encoder (k, v) (B,Senc,KV,hd)."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    k, v = enc_kv
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=x.device)
    o = _sdpa(q, k, v, mask, cfg)
    return _out(o, p["wo"])


def encoder_kv(p: Params,
               enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = enc_out.dtype
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


# ---------------------------------------------------------------------------
# Decode path (static KV cache)
# ---------------------------------------------------------------------------

def attention_decode(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, cfg: ArchConfig,
                     write_pos: Optional[int] = None):
    """One-token decode.  x (B, 1, D); caches (B, S_cache, KV, hd);
    ``pos`` is the absolute position, an int (drives RoPE and the
    validity mask); ``write_pos`` the cache slot (== pos for global
    layers, pos % ring for the ring cache of sliding-window layers —
    ring entries are all within the window by construction, so validity
    is just "slot already written").  The new K/V are written into the
    caches in place, at the slot clamped to the cache as the JAX
    package's ``dynamic_update_slice`` clamps it.  Returns (out,
    k_cache, v_cache)."""
    s_cache = k_cache.shape[1]
    wp = min(max(pos if write_pos is None else write_pos, 0), s_cache - 1)
    q, k, v = _qkv(p, x, cfg)
    sin, cos = rope_angles(torch.full((1,), pos, device=x.device), cfg.hd,
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    k_cache[:, wp:wp + 1] = k.to(k_cache.dtype)
    v_cache[:, wp:wp + 1] = v.to(v_cache.dtype)

    if pos >= s_cache:
        mask = torch.ones((1, s_cache), dtype=torch.bool, device=x.device)
    else:
        mask = (torch.arange(s_cache, device=x.device) <= pos)[None, :]
    o = _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask, cfg)
    return _out(o, p["wo"]), k_cache, v_cache
