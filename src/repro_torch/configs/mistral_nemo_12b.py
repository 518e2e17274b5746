"""mistral-nemo-12b [dense] — 40L d5120 32H (GQA kv=8, head_dim 128)
ff14336 vocab 131072, 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336,
    vocab=131072, head_dim=128, rope_theta=1e6,
    group_pattern=(("attn", "dense"),),
    tie_embeddings=False,
)
