"""Qwen3-30B-A3B [moe] — 128 experts top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                 # per-expert FFN width
    vocab=151936,
    act="swiglu",
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
    rms_eps=1e-6,
)
