"""InternVL2-76B [vlm] — InternViT frontend (STUB: precomputed patch
embeddings via input_specs) + 76B LM backbone. [arXiv:2404.16821; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    act="swiglu",
    rope_theta=500000.0,
    rms_eps=1e-5,
    frontend="vision",
    frontend_len=256,         # patch-embedding prefix length
)
