"""Unified model API over all families (decoder-only / MoE / hybrid / SSM
/ enc-dec / VLM): init, loss, prefill, decode, input specs per shape cell.

The single surface the launcher, the smoke and the tests go through —
per-family dispatch lives here and nowhere else.  Parameters stay a dict
of tensors with the JAX package's tree and leaf names, under plain
functions on tensors; :class:`Model` is a thin facade over them.  Every
method that creates tensors takes ``device`` (``None`` means the card,
and raises without one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ArchConfig, ShapeCell
from repro_torch.models.transformer import dtype_of

Params = Dict[str, Any]


def _generator(seed_or_generator: Union[int, torch.Generator, None],
               device: torch.device):
    """A generator on ``device``: the one given, or a new one seeded with
    the int given; none on ``"meta"``, where nothing is drawn."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed_or_generator))


@dataclass
class Model:
    cfg: ArchConfig

    # -- parameters -----------------------------------------------------------
    def init(self, seed_or_generator: Union[int, torch.Generator],
             device=None) -> Params:
        """Random parameters on ``device`` from a seed or a generator on
        that device."""
        device = resolve_device(device)
        gen = _generator(seed_or_generator, device)
        if self.cfg.enc_dec:
            return encdec.init_params(self.cfg, gen, device)
        return transformer.init_params(self.cfg, gen, device)

    # -- training --------------------------------------------------------------
    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.cfg.enc_dec:
            return encdec.seq2seq_loss(params, batch, self.cfg)
        return transformer.lm_loss(params, batch, self.cfg)

    # -- serving -----------------------------------------------------------------
    def prefill(self, params: Params,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.cfg.enc_dec:
            enc_out = encdec.encode(params, batch["frames"], self.cfg)
            logits = encdec.decode_train(params, batch["tokens"], enc_out,
                                         self.cfg)
            return logits[:, -1:]
        return transformer.prefill(params, batch["tokens"], self.cfg,
                                   batch.get("patches"))

    def init_caches(self, params_or_none, batch: int, s_max: int,
                    device=None) -> Params:
        if self.cfg.enc_dec:
            return encdec.init_caches(params_or_none, self.cfg, batch, s_max,
                                      device=device)
        return transformer.init_caches(self.cfg, batch, s_max, device)

    def decode(self, params: Params, caches: Params, tokens: torch.Tensor,
               pos: int):
        """One token at absolute position ``pos`` (an int); the caches
        are updated in place and returned with the logits."""
        if self.cfg.enc_dec:
            return encdec.decode_step(params, caches, tokens, pos, self.cfg)
        return transformer.decode_step(params, caches, tokens, pos, self.cfg)

    # -- shape cells ---------------------------------------------------------------
    def input_specs(self, cell: ShapeCell) -> Dict[str, Any]:
        """Stand-ins for every model input of this cell, on the
        ``"meta"`` device (no allocation).  For decode cells this
        includes the caches."""
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len
        meta = torch.device("meta")
        act = dtype_of(cfg.dtype)

        def tok(shape):
            return torch.empty(shape, dtype=torch.int32, device=meta)

        def emb(n):
            return torch.empty((B, n, cfg.d_model), dtype=act, device=meta)

        if cell.kind == "train":
            if cfg.enc_dec:
                return {"frames": emb(cfg.n_frames),
                        "tokens": tok((B, S)), "labels": tok((B, S))}
            if cfg.vlm:
                s_text = S - cfg.n_patches
                return {"tokens": tok((B, s_text)),
                        "labels": tok((B, s_text)),
                        "patches": emb(cfg.n_patches)}
            return {"tokens": tok((B, S)), "labels": tok((B, S))}

        if cell.kind == "prefill":
            if cfg.enc_dec:
                return {"frames": emb(cfg.n_frames), "tokens": tok((B, S))}
            if cfg.vlm:
                return {"tokens": tok((B, S - cfg.n_patches)),
                        "patches": emb(cfg.n_patches)}
            return {"tokens": tok((B, S))}

        assert cell.kind == "decode"
        params = self.init(None, device=meta) if cfg.enc_dec else None
        return {"tokens": tok((B, 1)), "pos": tok(()),
                "caches": self.init_caches(params, B, S, device=meta)}

    # -- synthetic batches for smoke tests / examples ---------------------------------
    def dummy_batch(self, cell: ShapeCell, seed: int,
                    device=None) -> Dict[str, Any]:
        """Materialize :meth:`input_specs` on ``device``: tokens and
        labels uniform in the vocabulary, each drawn from a generator
        seeded with ``seed`` (so tokens and labels of one shape are
        equal, as one key gives in the JAX package), every other leaf
        zero."""
        device = resolve_device(device)

        def make(name, s):
            if isinstance(s, dict):
                return {k: make(k, v) for k, v in s.items()}
            if s.dtype == torch.int32 and name in ("tokens", "labels"):
                gen = torch.Generator(device=device).manual_seed(seed)
                return torch.randint(0, self.cfg.vocab, s.shape,
                                     generator=gen, dtype=torch.int32,
                                     device=device)
            return torch.zeros(s.shape, dtype=s.dtype, device=device)

        return {k: make(k, v) for k, v in self.input_specs(cell).items()}


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6·N_active·D for train, 2·N_active·D for inference
    (forward only): the 'useful compute' yardstick."""
    n_active = active_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_active * tokens


def active_params(cfg: ArchConfig) -> float:
    """Active (per-token) parameter count, analytic."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv
    attn_p = d * hd * (h + 2 * kv) + h * hd * d
    dense_p = 3 * d * ff
    m = cfg.moe
    moe_active = 3 * d * m.d_ff_expert * m.top_k + \
        3 * d * m.d_ff_shared * m.n_shared + d * m.n_experts
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    ssm_p = 2 * d * di + 2 * d * n + d * (di // max(cfg.ssm_headdim, 1)) \
        + di * d + cfg.ssm_conv * (di + 2 * n)

    total = v * d  # embedding (active on input+output)
    if not cfg.tie_embeddings:
        total += v * d

    def block_cost(spec):
        mixer, mlp = spec
        c = 0.0
        if mixer in ("attn", "attn_local"):
            c += attn_p
        elif mixer == "mamba":
            c += ssm_p
        if mlp == "dense":
            c += dense_p
        elif mlp == "moe":
            c += moe_active
        return c

    if cfg.first_layer_override:
        total += block_cost(cfg.first_layer_override)
    per_group = sum(block_cost(s) for s in cfg.group_pattern)
    total += per_group * cfg.n_groups
    if cfg.enc_dec:
        total += cfg.n_enc_layers * (attn_p + 2 * d * ff) \
            + cfg.n_layers * attn_p  # cross attention
    return float(total)


def total_params(cfg: ArchConfig) -> float:
    """Total parameter count (MoE experts all counted)."""
    m = cfg.moe
    if not m.n_experts:
        return active_params(cfg)
    moe_total_minus_active = 3 * cfg.d_model * m.d_ff_expert * \
        (m.n_experts - m.top_k)
    n_moe_layers = sum(1 for s in cfg.group_pattern if s[1] == "moe") * \
        cfg.n_groups
    return active_params(cfg) + moe_total_minus_active * n_moe_layers
