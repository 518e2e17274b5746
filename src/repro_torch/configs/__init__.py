"""Architecture registry: ``--arch <id>`` resolves here.

``repro_torch.configs.get(name)`` returns the full :class:`ArchConfig`;
``get_reduced(name)`` the CPU-test-sized variant of the same family.
The values are the JAX package's, architecture for architecture.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.models.config import ArchConfig

from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.granite_moe_1b import CONFIG as _granite_moe
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.jamba_1_5_large import CONFIG as _jamba
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in [
        _qwen, _gemma3, _nemo, _granite, _granite_moe,
        _deepseek, _jamba, _whisper, _llava, _mamba2,
    ]
}


def names() -> List[str]:
    return list(ARCHS)


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_reduced(name: str, **overrides) -> ArchConfig:
    return get(name).reduced(**overrides)
