"""llava-next-34b [vlm] — 60L d7168 56H (GQA kv=8) ff20480 vocab 64000
text backbone; anyres vision tiling is a STUB (input_specs provides
precomputed patch embeddings, 576 base patches).
[hf:llava-hf/llava-v1.6-34b-hf; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480,
    vocab=64000, head_dim=128, rope_theta=5e6,
    group_pattern=(("attn", "dense"),),
    vlm=True, n_patches=576,
    tie_embeddings=False,
)
