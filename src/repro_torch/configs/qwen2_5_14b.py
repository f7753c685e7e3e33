"""Qwen2.5-14B [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    act="swiglu",
    qkv_bias=True,            # Qwen2-family signature
    rope_theta=1_000_000.0,
    rms_eps=1e-6,
)
