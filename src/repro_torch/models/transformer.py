"""Decoder-only transformer stack (covers dense, MoE, hybrid and SSM
families, plus the LLaVA text backbone with stubbed patch embeddings).

The layer stack is a loop over *groups* (one group = one period of
``cfg.group_pattern``); every leaf of ``params["groups"]`` carries a
leading (n_groups,) axis, the JAX package's parameter tree.  The
forward unbinds each stacked leaf once (views; under autograd its
backward is one ``stack``, where indexing each group would write a
zero tensor of the whole stacked leaf per group); decode indexes it.

Activation checkpointing (``cfg.remat``), while autograd records: each
group's body runs under ``torch.utils.checkpoint`` and keeps only the
outputs of its products without batch dims (the JAX package's
``dots_with_no_batch_dims_saveable`` policy), recomputing the rest in
the backward.  Values and gradients are the same with it on and off.

Decode state: per group-position either an attention KV cache
(n_groups, B, S_cache, KV, hd) or an SSM state {h, conv_*} with a leading
(n_groups,) axis.  :func:`decode_step` writes the new entries into the
caches in place and returns them.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (embed, init_embed, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm)

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` / ``param_dtype`` name."""
    return getattr(torch, name)


def _index(tree, i: int):
    """Every leaf of a stacked tree at index ``i`` (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> List[Any]:
    """A stacked tree as ``n`` trees, one ``torch.unbind`` a leaf (views,
    no copies; under autograd the backward of each is one ``stack``)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


_aten = torch.ops.aten


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the outputs of products without batch dims (``mm``,
    ``addmm``, and the ``bmm`` of batch 1 that an einsum contracting no
    batch dim lowers to); recompute everything else, batched products
    included."""
    if op in (_aten.mm.default, _aten.addmm.default) or \
            (op == _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(body: Callable, cfg: ArchConfig,
          save_products: bool) -> Callable:
    """``body`` under activation checkpointing when ``cfg.remat`` is set
    and autograd records, else ``body`` itself: with ``save_products``
    the outputs of products without batch dims are kept
    (:func:`_save_products`), without it nothing inside is kept."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body
    kw = {"use_reentrant": False}
    if save_products:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_products)
    return functools.partial(checkpoint, body, **kw)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen, spec, cfg: ArchConfig, pdt, device, lead=()) -> Params:
    mixer_kind, mlp_kind = spec
    p: Params = {"mixer_norm": init_rmsnorm(cfg.d_model, pdt, device, lead),
                 "mlp_norm": init_rmsnorm(cfg.d_model, pdt, device, lead)}
    if mixer_kind in ("attn", "attn_local"):
        p["mixer"] = attn.init_attention(gen, cfg, pdt, device, lead)
    elif mixer_kind == "mamba":
        p["mixer"] = ssm_mod.init_ssm(gen, cfg, pdt, device, lead)
    elif mixer_kind != "none":
        raise ValueError(mixer_kind)
    if mlp_kind == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, pdt, device, lead)
    elif mlp_kind == "moe":
        p["mlp"] = moe_mod.init_moe(gen, cfg, pdt, device, lead)
    elif mlp_kind == "none":      # pure-mixer block (mamba2)
        del p["mlp_norm"]
    else:
        raise ValueError(mlp_kind)
    return p


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                device=None) -> Params:
    """Random parameters drawn from ``gen`` on ``device`` (``None``
    means the card; ``gen`` may be ``None`` only on ``"meta"``)."""
    device = resolve_device(device)
    pdt = dtype_of(cfg.param_dtype)
    params: Params = {
        "embed": init_embed(gen, cfg.vocab, cfg.d_model, pdt, device),
        "final_norm": init_rmsnorm(cfg.d_model, pdt, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embed(gen, cfg.vocab, cfg.d_model, pdt,
                                       device)
    if cfg.first_layer_override:
        params["first"] = _init_block(gen, cfg.first_layer_override, cfg,
                                      pdt, device)
    lead = (cfg.n_groups,)
    params["groups"] = {
        f"pos_{i}": _init_block(gen, spec, cfg, pdt, device, lead)
        for i, spec in enumerate(cfg.group_pattern)}
    return params


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _apply_block(bp: Params, spec, x: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    mixer_kind, mlp_kind = spec
    if mixer_kind != "none":
        h = rmsnorm(bp["mixer_norm"], x, cfg.norm_eps)
        if mixer_kind == "attn":
            x = x + attn.attention(bp["mixer"], h, cfg, local=False)
        elif mixer_kind == "attn_local":
            x = x + attn.attention(bp["mixer"], h, cfg, local=True)
        else:
            x = x + ssm_mod.ssd_forward(bp["mixer"], h, cfg)
    if mlp_kind != "none":
        h = rmsnorm(bp["mlp_norm"], x, cfg.norm_eps)
        if mlp_kind == "dense":
            x = x + mlp(bp["mlp"], h)
        else:
            x = x + moe_mod.moe_layer(bp["mlp"], h, cfg)
    return x


def forward_hidden(params: Params, x: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    """Embedded input (B, S, D) -> final hidden states (B, S, D)."""
    if cfg.first_layer_override:
        x = _apply_block(params["first"], cfg.first_layer_override, x, cfg)

    def group_body(xc, gp):
        for i, spec in enumerate(cfg.group_pattern):
            xc = _apply_block(gp[f"pos_{i}"], spec, xc, cfg)
        return xc

    body = remat(group_body, cfg, save_products=True)
    for gp in _unbind(params["groups"], cfg.n_groups):
        x = body(x, gp)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """'bsd,vd->bsv' against the (tied or separate) table, in x's dtype."""
    head = params.get("lm_head", params["embed"])
    return torch.matmul(x, head["table"].to(x.dtype).t())


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S[, + patches (B, P, D)]) -> logits (B, S_total, V) in
    the activation dtype."""
    dt = dtype_of(cfg.dtype)
    x = embed(params["embed"], tokens, dt)
    if patches is not None:
        x = torch.cat([patches.to(dt), x], dim=1)
    x = forward_hidden(params, x, cfg)
    return _head(params, x)


def next_token_nll(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of logits (B, S, V) against labels
    (B, S); labels < 0 are masked out."""
    lg = logits[:, :-1].float()
    tg = labels[:, 1:].long()
    mask = (tg >= 0).float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, torch.clamp(tg, min=0)[..., None])[..., 0]
    nll = (lse - picked) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig) -> torch.Tensor:
    """Next-token cross-entropy; labels < 0 are masked out."""
    logits = forward(params, batch["tokens"], cfg, batch.get("patches"))
    n_patch = 0 if batch.get("patches") is None else batch["patches"].shape[1]
    return next_token_nll(logits[:, n_patch:], batch["labels"])


# ---------------------------------------------------------------------------
# Decode (one token, static caches)
# ---------------------------------------------------------------------------

def local_cache_len(cfg: ArchConfig, s_max: int) -> int:
    """Ring size of a sliding-window layer's cache: it only ever reads the
    last ``sliding_window`` positions, so its cache is bounded by the
    window (rounded up to a power of two), not the context."""
    return min(s_max, int(2 ** math.ceil(math.log2(max(cfg.sliding_window,
                                                       2)))))


def init_caches(cfg: ArchConfig, batch: int, s_max: int,
                device=None) -> Params:
    """Per-group-position stacked caches, zero, on ``device`` (``None``
    means the card)."""
    device = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    caches: Params = {}

    def kv(lead, s_cache):
        shape = lead + (batch, s_cache, cfg.n_kv, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    for i, (mixer_kind, _) in enumerate(cfg.group_pattern):
        if mixer_kind in ("attn", "attn_local"):
            s_cache = s_max if mixer_kind == "attn" else \
                local_cache_len(cfg, s_max)
            caches[f"pos_{i}"] = kv((cfg.n_groups,), s_cache)
        elif mixer_kind == "mamba":
            caches[f"pos_{i}"] = ssm_mod.ssm_decode_state(
                cfg, batch, device, lead=(cfg.n_groups,))
    if cfg.first_layer_override:
        mixer_kind, _ = cfg.first_layer_override
        if mixer_kind in ("attn", "attn_local"):
            caches["first"] = kv((), s_max)
        elif mixer_kind == "mamba":
            caches["first"] = ssm_mod.ssm_decode_state(cfg, batch, device)
    return caches


def _decode_block(bp: Params, cache, spec, x, pos: int, cfg: ArchConfig):
    """One block of one decode step; ``cache`` (views into the stacked
    caches) is updated in place."""
    mixer_kind, mlp_kind = spec
    if mixer_kind != "none":
        h = rmsnorm(bp["mixer_norm"], x, cfg.norm_eps)
        if mixer_kind in ("attn", "attn_local"):
            s_cache = cache["k"].shape[1]
            # local layers write round-robin into their window-sized ring
            wpos = pos % s_cache if mixer_kind == "attn_local" else pos
            o, _, _ = attn.attention_decode(
                bp["mixer"], h, cache["k"], cache["v"], pos, cfg,
                write_pos=wpos)
            x = x + o
        else:
            o, new_state = ssm_mod.ssd_decode(bp["mixer"], h, cache, cfg)
            for k, v in new_state.items():
                cache[k].copy_(v)
            x = x + o
    if mlp_kind != "none":
        h = rmsnorm(bp["mlp_norm"], x, cfg.norm_eps)
        if mlp_kind == "dense":
            x = x + mlp(bp["mlp"], h)
        else:
            x = x + moe_mod.moe_layer(bp["mlp"], h, cfg)
    return x


def decode_step(params: Params, caches: Params, tokens: torch.Tensor,
                pos: int, cfg: ArchConfig):
    """tokens (B, 1) at absolute position ``pos`` (an int) -> (logits
    (B,1,V), caches), the caches updated in place."""
    dt = dtype_of(cfg.dtype)
    x = embed(params["embed"], tokens, dt)

    if cfg.first_layer_override:
        x = _decode_block(params["first"], caches.get("first"),
                          cfg.first_layer_override, x, pos, cfg)
    for g in range(cfg.n_groups):
        gp = _index(params["groups"], g)
        for i, spec in enumerate(cfg.group_pattern):
            c = caches.get(f"pos_{i}")
            x = _decode_block(gp[f"pos_{i}"],
                              None if c is None else _index(c, g),
                              spec, x, pos, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x), caches


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill = forward pass returning last-position logits (the
    cache-populating variant is exercised through decode_step; the
    compute shape is the forward's)."""
    logits = forward(params, tokens, cfg, patches)
    return logits[:, -1:]
