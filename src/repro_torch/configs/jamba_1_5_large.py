"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) ff24576,
Mamba:attention 7:1 interleave, MoE 16 experts top-2 on every other
layer, vocab 65536.  [arXiv:2403.19887]

Period-8 group: attention at in-block index 4, MoE at odd indices —
9 groups × 8 layers = 72.  Mamba settings follow the Jamba paper
(d_state 16, headdim 64, expand 2 → d_inner 16384, 256 ssm heads)."""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576,
    vocab=65536, head_dim=128, rope_theta=1e4,
    group_pattern=(
        ("mamba", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe"),
        ("attn", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe"),
    ),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    ssm_expand=2, ssm_state=16, ssm_headdim=64, ssm_chunk=256,
    tie_embeddings=False,
    subquadratic=True,
)
