"""Granite-MoE-3B-A800M [hf:ibm-granite/granite-3.0-1b-a400m-base family; hf] — 40 experts top-8."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=0, d_ff_expert=512, n_experts=40, top_k=8,
    vocab=49155, tie_embeddings=True, grad_accum=4,
))
