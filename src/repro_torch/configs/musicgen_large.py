"""MusicGen-large [audio] — decoder-only transformer over EnCodec tokens;
text-conditioning frontend is a STUB (precomputed conditioning embeddings
via input_specs). [arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,               # EnCodec codebook
    act="gelu",
    rope_theta=10000.0,
    frontend="audio",
    frontend_len=64,          # conditioning prefix
)
