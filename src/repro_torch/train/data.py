"""Deterministic synthetic LM data pipeline.

Fault-tolerance property: the batch for (seed, step, shard) is a pure
function — any node can recompute any other node's shard after a
failure, and restart-at-step-k is bit-exact without data-loader state in
the checkpoint.  Real deployments swap `_tokens_for` for a deterministic
tokenized-shard reader with the same (seed, step, shard) contract.

Batches are numpy, bit-identical to the JAX package's for the same
(seed, step, shard, n_shards); :func:`as_tensors` moves one to a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ArchConfig, ShapeCell

__all__ = ["DataConfig", "as_tensors", "make_batch"]


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    # a tiny Markov-ish structure so losses actually go down
    pattern_period: int = 17


def _tokens_for(dc: DataConfig, step: int, shard: int, shape) -> np.ndarray:
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, shard]))
    b, s = shape
    base = rng.integers(0, dc.vocab, (b, 1))
    drift = rng.integers(1, 5, (b, 1))
    pos = np.arange(s)[None, :]
    noise = rng.integers(0, dc.vocab, (b, s))
    mix = rng.random((b, s)) < 0.25
    toks = (base + drift * (pos % dc.pattern_period)) % dc.vocab
    return np.where(mix, noise, toks).astype(np.int32)


def make_batch(dc: DataConfig, cfg: ArchConfig, cell: ShapeCell, step: int,
               shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    b = cell.global_batch // n_shards
    s = cell.seq_len
    dcv = DataConfig(dc.seed, min(dc.vocab, cfg.vocab), dc.pattern_period)
    if cfg.enc_dec:
        rng = np.random.default_rng(np.random.SeedSequence([dc.seed, step, shard, 7]))
        frames = rng.standard_normal((b, cfg.n_frames, cfg.d_model)).astype(np.float32) * 0.1
        toks = _tokens_for(dcv, step, shard, (b, s))
        return {"frames": frames, "tokens": toks, "labels": toks.copy()}
    if cfg.vlm:
        rng = np.random.default_rng(np.random.SeedSequence([dc.seed, step, shard, 9]))
        patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.1
        toks = _tokens_for(dcv, step, shard, (b, s - cfg.n_patches))
        return {"tokens": toks, "labels": toks.copy(), "patches": patches}
    toks = _tokens_for(dcv, step, shard, (b, s))
    return {"tokens": toks, "labels": toks.copy()}


def as_tensors(batch: Dict[str, np.ndarray],
               device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(np.array(v, order="C")).to(device)
            for k, v in batch.items()}
