"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407; hf] — 128k ctx, head_dim=128."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1_000_000.0,
    grad_accum=2, train_act_shard="seq",
))
