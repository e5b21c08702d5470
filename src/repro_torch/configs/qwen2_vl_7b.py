"""Qwen2-VL-7B [arXiv:2409.12191; hf] — M-RoPE, dynamic resolution (vision stub)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, rope_theta=1_000_000.0,
    m_rope_sections=(16, 24, 24), n_patch_tokens=1024, use_bias=True,
    grad_accum=4, train_act_shard="seq",
))
