"""granite-moe-1b-a400m [moe] — 24L d1024 16H (GQA kv=8), MoE 32 experts
top-8, expert ff 512, vocab 49155.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512,
    vocab=49155, rope_theta=1e4,
    group_pattern=(("attn", "moe"),),
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
)
