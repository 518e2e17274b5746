"""deepseek-moe-16b [moe] — 28L d2048 16H (kv=16), fine-grained MoE:
64 routed experts top-6 + 2 shared experts (ff 1408 each), dense first
layer (ff 10944), vocab 102400.  [arXiv:2401.06066]"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=10944,
    vocab=102400, rope_theta=1e4,
    group_pattern=(("attn", "moe"),),
    first_layer_override=("attn", "dense"),   # DeepSeekMoE keeps layer 0 dense
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared=2, d_ff_shared=1408),
    tie_embeddings=False,
)
