"""whisper-small [audio] — enc-dec 12+12L d768 12H (kv=12) ff3072
vocab 51865; conv/mel frontend is a STUB (input_specs provides
precomputed frame embeddings, n_frames=1500).  [arXiv:2212.04356]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072,
    vocab=51865, qkv_bias=True, rope_theta=1e4,
    group_pattern=(("attn", "dense"),),
    enc_dec=True, n_enc_layers=12, n_frames=1500,
    tie_embeddings=True,
)
