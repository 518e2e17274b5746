"""Architecture configuration.

One :class:`ArchConfig` describes any of the assigned architectures; the
layer stack is expressed as a repeating *group pattern* (period-p list of
block descriptors), so heterogeneous stacks (gemma3's 5:1 local:global,
jamba's 7:1 mamba:attention with interleaved MoE) share one parameter
layout: every leaf of a group carries a leading ``(n_groups,)`` axis and
the forward pass loops over groups.

The fields and defaults are the JAX package's, so a config reads the same
in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block descriptor: (mixer, mlp)
#   mixer ∈ {"attn", "attn_local", "mamba", "none"}
#   mlp   ∈ {"dense", "moe", "none"}
BlockSpecT = Tuple[str, str]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    n_shared: int = 0          # always-on shared experts (DeepSeekMoE)
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    # dispatch in this many independent token blocks, each routed with
    # its own per-block capacity (totals identical); 0 = one global
    # dispatch (the GShard-style baseline)
    dispatch_blocks: int = 0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | audio | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 1024           # for attn_local blocks
    group_pattern: Tuple[BlockSpecT, ...] = (("attn", "dense"),)
    first_layer_override: Optional[BlockSpecT] = None  # e.g. deepseek dense L0
    moe: MoEConfig = MoEConfig()
    # ssm (mamba2)
    ssm_expand: int = 2
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500                 # stub frontend sequence length
    # vlm
    vlm: bool = False
    n_patches: int = 576                 # stub anyres patch count per example
    # numerics / runtime
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # activation checkpointing of the group body while autograd records
    # (torch.utils.checkpoint); no effect on inference
    remat: bool = True
    # the JAX package's scan unroll factor; no effect on one card yet
    scan_unroll: int = 1
    # shard optimizer state over the data axis (models/sharding.py's
    # opt_state_specs); no effect on one card
    zero1: bool = False
    # flash-style chunked attention for train/prefill self-attention
    # (online softmax over KV chunks; 0 = dense S×S path)
    flash_chunk: int = 0
    # serve decode data-parallel only (params replicated, no tensor
    # parallelism); a sharding knob, no effect on one card yet
    dp_only_decode: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # long-context capability (decides long_500k applicability)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        p = len(self.group_pattern)
        layers = self.n_layers - (1 if self.first_layer_override else 0)
        assert layers % p == 0, (self.name, self.n_layers, p)
        return layers // p

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=len(self.group_pattern) * 2
            + (1 if self.first_layer_override else 0),
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 4) if self.n_kv >= self.n_heads // 4 else 2,
            d_ff=128,
            vocab=512,
            head_dim=16,
            n_enc_layers=2 if self.enc_dec else 0,
            n_frames=16 if self.enc_dec else self.n_frames,
            n_patches=8 if self.vlm else self.n_patches,
            ssm_state=16,
            ssm_headdim=8,
            ssm_chunk=8,
            sliding_window=8,
            remat=False,
        )
        if self.moe.n_experts:
            small["moe"] = MoEConfig(
                n_experts=4, top_k=min(2, self.moe.top_k), d_ff_expert=32,
                n_shared=min(1, self.moe.n_shared), d_ff_shared=32,
                capacity_factor=2.0)
        small.update(overrides)
        # keep n_kv dividing n_heads
        cfg = dataclasses.replace(self, **small)
        assert cfg.n_heads % cfg.n_kv == 0
        return cfg


# ---------------------------------------------------------------------------
# Input-shape cells (assigned to every architecture)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_applicable(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """(runnable, reason).  long_500k only for sub-quadratic archs."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention architecture: 524288-token dense KV "
                       "decode excluded per DESIGN.md §Arch-applicability")
    return True, ""
