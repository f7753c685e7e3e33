"""Nemotron-4-15B [dense] — GQA + squared-ReLU FFN (ungated).
[arXiv:2402.16819; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="sq_relu",            # Primer-style squared ReLU, no gate
    rope_theta=10000.0,
    rms_eps=1e-5,
)
