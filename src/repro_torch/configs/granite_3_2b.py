"""granite-3-2b [dense] — 40L d2048 32H (GQA kv=8) ff8192 vocab 49155.
[hf:ibm-granite/granite-3.0-2b-base]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv=8, d_ff=8192,
    vocab=49155, rope_theta=1e4,
    group_pattern=(("attn", "dense"),),
    tie_embeddings=True,
)
