"""StableLM-3B [dense] — kv=32 means full MHA.
[hf:stabilityai/stablelm-*; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    act="swiglu",
    rope_theta=10000.0,
    rms_eps=1e-5,
)
