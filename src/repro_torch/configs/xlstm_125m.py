"""xLSTM-125M [ssm] — mLSTM blocks with sLSTM every 4th layer.
[arXiv:2405.04517; unverified]

sub_quadratic: pure recurrent state, O(1) per decode step — runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                   # xLSTM blocks carry their own up-projections
    vocab=50304,
    slstm_every=4,            # sLSTM at layers 3, 7, 11 (xLSTM mixed ratio)
    mlstm_proj_factor=2.0,
    sub_quadratic=True,
)
