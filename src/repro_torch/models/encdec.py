"""Whisper-style encoder-decoder backbone.

The conv/mel frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (B, n_frames, d_model); the transformer backbone (12+12
layers for whisper-small) is the system under test.  Encoder layers are
bidirectional; decoder layers interleave causal self-attention,
cross-attention over the encoder output, and GELU FFNs.  Both stacks keep
per-layer-stacked parameters (a leading layer axis on every leaf) and
loop over layers (the stacked leaves unbound once a forward; each
layer's body under activation checkpointing, nothing inside kept, when
``cfg.remat`` is set and autograd records).

Decode state = causal self-KV caches plus the cross K/V projections
computed once from the encoder output (the standard serving split).
:func:`decode_step` writes the self-KV entries in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (embed, gelu_mlp, init_embed,
                                       init_gelu_mlp, init_layernorm,
                                       layernorm)
from repro_torch.models.transformer import (_head, _index, _unbind,
                                            dtype_of, next_token_nll, remat)

Params = Dict[str, Any]


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                device=None) -> Params:
    """Random parameters drawn from ``gen`` on ``device`` (``None``
    means the card; ``gen`` may be ``None`` only on ``"meta"``)."""
    device = resolve_device(device)
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    enc = (cfg.n_enc_layers,)
    dec = (cfg.n_layers,)
    return {
        "embed": init_embed(gen, cfg.vocab, d, pdt, device),
        "enc_layers": {
            "attn": attn.init_attention(gen, cfg, pdt, device, enc),
            "attn_norm": init_layernorm(d, pdt, device, enc),
            "mlp": init_gelu_mlp(gen, d, cfg.d_ff, pdt, device, enc),
            "mlp_norm": init_layernorm(d, pdt, device, enc),
        },
        "enc_norm": init_layernorm(d, pdt, device),
        "dec_layers": {
            "self": attn.init_attention(gen, cfg, pdt, device, dec),
            "self_norm": init_layernorm(d, pdt, device, dec),
            "cross": attn.init_cross_attention(gen, cfg, pdt, device, dec),
            "cross_norm": init_layernorm(d, pdt, device, dec),
            "mlp": init_gelu_mlp(gen, d, cfg.d_ff, pdt, device, dec),
            "mlp_norm": init_layernorm(d, pdt, device, dec),
        },
        "dec_norm": init_layernorm(d, pdt, device),
    }


def encode(params: Params, frames: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """frames (B, F, D) stub embeddings -> encoder states (B, F, D)."""
    x = frames.to(dtype_of(cfg.dtype))

    def body(xc, lp):
        h = layernorm(lp["attn_norm"], xc, cfg.norm_eps)
        xc = xc + attn.attention_bidir(lp["attn"], h, cfg)
        h = layernorm(lp["mlp_norm"], xc, cfg.norm_eps)
        return xc + gelu_mlp(lp["mlp"], h)

    body = remat(body, cfg, save_products=False)
    for lp in _unbind(params["enc_layers"], cfg.n_enc_layers):
        x = body(x, lp)
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Teacher-forced decoder -> logits (B, S, V)."""
    x = embed(params["embed"], tokens, dtype_of(cfg.dtype))

    def body(xc, lp, enc):
        h = layernorm(lp["self_norm"], xc, cfg.norm_eps)
        xc = xc + attn.attention(lp["self"], h, cfg)
        h = layernorm(lp["cross_norm"], xc, cfg.norm_eps)
        kv = attn.encoder_kv(lp["cross"], enc)
        xc = xc + attn.cross_attention(lp["cross"], h, kv, cfg)
        h = layernorm(lp["mlp_norm"], xc, cfg.norm_eps)
        return xc + gelu_mlp(lp["mlp"], h)

    body = remat(body, cfg, save_products=False)
    for lp in _unbind(params["dec_layers"], cfg.n_layers):
        x = body(x, lp, enc_out)
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    return _head(params, x)


def seq2seq_loss(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ArchConfig) -> torch.Tensor:
    enc_out = encode(params, batch["frames"], cfg)
    logits = decode_train(params, batch["tokens"], enc_out, cfg)
    return next_token_nll(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_caches(params: Params, cfg: ArchConfig, batch: int, s_max: int,
                enc_out: Optional[torch.Tensor] = None,
                device=None) -> Params:
    """Self-KV caches (zero) + per-layer cross K/V from the encoder output
    (a zero stub output when none is given), on ``device`` (``None``
    means the card)."""
    device = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    L = cfg.n_layers
    shape = (L, batch, s_max, cfg.n_kv, cfg.hd)
    caches: Params = {"k": torch.zeros(shape, dtype=dt, device=device),
                      "v": torch.zeros(shape, dtype=dt, device=device)}
    if enc_out is None:
        enc_out = torch.zeros((batch, cfg.n_frames, cfg.d_model), dtype=dt,
                              device=device)
    cross = [attn.encoder_kv(_index(params["dec_layers"], i)["cross"],
                             enc_out) for i in range(L)]
    caches["cross_k"] = torch.stack([k.to(dt) for k, _ in cross])
    caches["cross_v"] = torch.stack([v.to(dt) for _, v in cross])
    return caches


def decode_step(params: Params, caches: Params, tokens: torch.Tensor,
                pos: int, cfg: ArchConfig):
    """tokens (B, 1) at absolute position ``pos`` (an int) -> (logits
    (B,1,V), caches), the self-KV caches updated in place."""
    x = embed(params["embed"], tokens, dtype_of(cfg.dtype))
    for i in range(cfg.n_layers):
        lp = _index(params["dec_layers"], i)
        h = layernorm(lp["self_norm"], x, cfg.norm_eps)
        o, _, _ = attn.attention_decode(lp["self"], h, caches["k"][i],
                                        caches["v"][i], pos, cfg)
        x = x + o
        h = layernorm(lp["cross_norm"], x, cfg.norm_eps)
        x = x + attn.cross_attention(
            lp["cross"], h, (caches["cross_k"][i].to(x.dtype),
                             caches["cross_v"][i].to(x.dtype)), cfg)
        h = layernorm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], h)
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    return _head(params, x), caches
