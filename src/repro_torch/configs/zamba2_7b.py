"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 + shared attention blocks."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    hybrid_attn_every=6,
    grad_accum=2,
))
