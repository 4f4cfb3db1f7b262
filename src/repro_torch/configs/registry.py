"""Architecture registry of the port: the archs whose families the port
runs.  The reference's other eight archs (moe, hybrid, vlm and audio
families) join with the slices that port those families."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [_falcon_mamba, _qwen3]}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)
