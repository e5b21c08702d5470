"""xLSTM-125M [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304, slstm_layers=(3, 9), grad_accum=2,
))
