"""gemma3-12b [dense] — 48L d3840 16H (GQA kv=8) ff15360 vocab 262144,
5:1 local:global interleave (sliding window 1024), 128k context.
[hf:google/gemma-3-12b-pt; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, d_ff=15360,
    vocab=262144, rope_theta=1e6, sliding_window=1024,
    # period-6 group: 5 sliding-window layers then 1 global layer
    group_pattern=(
        ("attn_local", "dense"), ("attn_local", "dense"),
        ("attn_local", "dense"), ("attn_local", "dense"),
        ("attn_local", "dense"), ("attn", "dense"),
    ),
    tie_embeddings=True,
)
