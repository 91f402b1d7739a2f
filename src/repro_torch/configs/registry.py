"""Architecture registry: --arch <id> resolution."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3_8b
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.internvl2_2b import CONFIG as _internvl
from repro_torch.configs.phi3_5_moe_42b import CONFIG as _phi35moe
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    _granite, _qwen3_4b, _phi4, _qwen3_8b, _seamless,
    _zamba2, _internvl, _phi35moe, _olmoe, _xlstm,
]}

_ALIASES = {
    "granite-3-2b": "granite-3-2b",
    "qwen3-4b": "qwen3-4b",
    "phi4-mini-3.8b": "phi4-mini-3.8b",
    "qwen3-8b": "qwen3-8b",
    "seamless-m4t-medium": "seamless-m4t-medium",
    "zamba2-7b": "zamba2-7b",
    "internvl2-2b": "internvl2-2b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "olmoe-1b-7b": "olmoe-1b-7b",
    "xlstm-1.3b": "xlstm-1.3b",
}


def get_arch(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]
