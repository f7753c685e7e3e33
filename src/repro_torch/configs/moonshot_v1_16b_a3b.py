"""Moonshot/Moonlight-16B-A3B [moe] — 64 experts top-6 + shared expert.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                # per-expert FFN width
    vocab=163840,
    act="swiglu",
    n_experts=64,
    top_k=6,
    moe_shared_ff=2816,       # DeepSeek-style shared expert (2x expert width)
    rope_theta=50000.0,
    rms_eps=1e-5,
)
