"""Granite-8B (code) [dense] — llama-architecture. [arXiv:2405.04324; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    act="swiglu",
    rope_theta=10_000_000.0,
    rms_eps=1e-5,
)
