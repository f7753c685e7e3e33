"""Architecture registry: the same ``ModelConfig`` instances as the JAX
package's ``configs`` (``base.py`` and the arch files are verbatim copies),
without its abstract jax input specs."""
from __future__ import annotations

from .base import SHAPES, InputShape, ModelConfig, shape_applicable
from .granite_8b import CONFIG as _granite
from .internvl2_76b import CONFIG as _internvl
from .moonshot_v1_16b_a3b import CONFIG as _moonshot
from .musicgen_large import CONFIG as _musicgen
from .nemotron_4_15b import CONFIG as _nemotron
from .qwen2_5_14b import CONFIG as _qwen25
from .qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from .stablelm_3b import CONFIG as _stablelm
from .xlstm_125m import CONFIG as _xlstm
from .zamba2_1_2b import CONFIG as _zamba2

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        _qwen25, _granite, _nemotron, _stablelm, _zamba2, _moonshot,
        _qwen3moe, _internvl, _xlstm, _musicgen,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "InputShape", "ModelConfig", "get_config",
           "shape_applicable"]
