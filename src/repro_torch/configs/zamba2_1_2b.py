"""Zamba2-1.2B [hybrid] — Mamba-2 backbone + ONE weight-shared attention+FFN
block applied periodically.  [arXiv:2411.15242; hf]

sub_quadratic: the SSM state is O(1) in sequence length and the shared
attention applications are sparse, so this arch runs the long_500k shape.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,              # Mamba-2 layers
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,                # shared block's FFN
    vocab=32000,
    act="swiglu",
    ssm_state=64,
    mamba_head_dim=128,       # d_inner = 32*128 = 4096 = 2x expansion
    shared_attn_every=6,      # shared attn+FFN block after every 6 mamba layers
    rope_theta=10000.0,
    sub_quadratic=True,
)
