"""mamba2-370m [ssm] — 48L d1024, attention-free SSD blocks
(d_state 128, headdim 64, expand 2 → d_inner 2048, 32 ssm heads),
vocab 50280.  [arXiv:2405.21060]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv=16, d_ff=0,
    vocab=50280,
    group_pattern=(("mamba", "none"),),
    ssm_expand=2, ssm_state=128, ssm_headdim=64, ssm_chunk=256,
    tie_embeddings=True,
    subquadratic=True,
    # 370M params replicate comfortably, so decode runs data-parallel
    # only (set per architecture, not globally); a sharding knob with no
    # effect on one card yet
    dp_only_decode=True,
)
