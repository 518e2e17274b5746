"""Primitive layers: norms, embeddings, RoPE, dense projections, MLPs.

Pure functions on tensors: parameters are plain dicts of tensors; every
init function takes an explicit ``torch.Generator`` (``None`` only on
the ``"meta"`` device, where nothing is drawn) and a device, and every
apply function takes ``(params, x)``.  Parameters of the layer stack
carry a leading ``(n_groups,)`` axis (see ``transformer.py``).

dtype policy: params in ``param_dtype`` (fp32 by default), activations in
``dtype`` (bf16); each weight is cast to the activation dtype where it is
used, and norms and softmax logits are computed in fp32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _init(gen: Optional[torch.Generator], shape: Sequence[int], scale: float,
          dtype: torch.dtype, device) -> torch.Tensor:
    """Normal(0, scale) draws in fp32, cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device, lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def init_layernorm(d: int, dtype, device,
                   lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d: int, dtype, device) -> Params:
    return {"table": _init(gen, (vocab, d), 1.0 / math.sqrt(d), dtype, device)}


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gathering the rows and then casting them gives the values of
    # casting the table and then gathering
    return p["table"][tokens.long()].to(dtype)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in fp32 for loss stability."""
    return torch.matmul(x.float(), p["table"].float().t())


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, hd: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape positions.shape + (hd/2,), fp32."""
    ar = torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device)
    freqs = theta ** (-ar / hd)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); sin/cos: (..., S, hd/2) broadcast over heads.
    Split-half convention: the first half pairs with the second."""
    dt = x.dtype
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, d: int, d_ff: int, dtype, device,
             lead: Tuple[int, ...] = ()) -> Params:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": _init(gen, lead + (d, d_ff), s_in, dtype, device),
        "w_up": _init(gen, lead + (d, d_ff), s_in, dtype, device),
        "w_down": _init(gen, lead + (d_ff, d), s_out, dtype, device),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (the assigned families all use gated MLPs)."""
    dt = x.dtype
    g = torch.matmul(x, p["w_gate"].to(dt))
    u = torch.matmul(x, p["w_up"].to(dt))
    h = F.silu(g) * u
    return torch.matmul(h, p["w_down"].to(dt))


def init_gelu_mlp(gen, d: int, d_ff: int, dtype, device,
                  lead: Tuple[int, ...] = ()) -> Params:
    """Non-gated GELU MLP (whisper encoder/decoder FFN)."""
    return {
        "w_in": _init(gen, lead + (d, d_ff), 1.0 / math.sqrt(d), dtype, device),
        "b_in": torch.zeros(lead + (d_ff,), dtype=dtype, device=device),
        "w_out": _init(gen, lead + (d_ff, d), 1.0 / math.sqrt(d_ff), dtype,
                       device),
        "b_out": torch.zeros(lead + (d,), dtype=dtype, device=device),
    }


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = torch.matmul(x, p["w_in"].to(dt)) + p["b_in"].to(dt)
    # the JAX package's gelu is the tanh approximation
    h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, p["w_out"].to(dt)) + p["b_out"].to(dt)
