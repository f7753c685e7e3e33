"""Architecture registry: the same ``ModelConfig`` instances as the JAX
package's ``configs`` (``base.py`` and the arch files are verbatim copies),
and its abstract input specs in PyTorch's idiom: tensors on the ``meta``
device, which have a shape and a dtype and hold no memory, where the
reference returns ``jax.ShapeDtypeStruct``s."""
from __future__ import annotations

import torch

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


def _spec(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Abstract train-step batch: tokens + labels (+ the frontend prefix,
    which takes ``frontend_len`` of the ``seq_len`` positions)."""
    b = shape.global_batch
    s = shape.seq_len
    specs = {}
    if cfg.frontend != "none":
        s_text = s - cfg.frontend_len
        specs["frontend"] = _spec((b, cfg.frontend_len, cfg.d_model),
                                  getattr(torch, cfg.dtype))
    else:
        s_text = s
    specs["tokens"] = _spec((b, s_text), torch.int32)
    specs["labels"] = _spec((b, s_text), torch.int32)
    return specs


def decode_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Abstract decode-step inputs: current token ids (the state's come from
    ``init_decode_state`` on the meta device)."""
    return {"tokens": _spec((shape.global_batch,), torch.int32)}


__all__ = ["ARCHS", "SHAPES", "InputShape", "ModelConfig", "get_config",
           "shape_applicable", "train_batch_specs", "decode_specs"]
