"""Architecture configs (one file per assigned arch) + reduced smoke variants."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeCell, SHAPES, cell_applicable, get_config, register,
    all_arch_names, pad_vocab,
)

ARCH_MODULES = [
    # the archs of the ported serving paths; the others join with their
    # slices
    "granite_moe_3b_a800m",
    "h2o_danube_3_4b",
    "mistral_nemo_12b",
    "zamba2_7b",
    "xlstm_125m",
    "qwen2_vl_7b",
]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test-sized config of the same family (runs a step on CPU)."""
    kw = dict(
        n_layers=4, d_model=64, n_heads=4, head_dim=16, d_ff=128,
        vocab=512, grad_accum=1, enc_frames=16,
    )
    kw["n_kv_heads"] = 2 if cfg.n_kv_heads < cfg.n_heads else 4
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=2, d_ff_expert=64)
    if cfg.family == "hybrid":
        kw.update(ssm_state=16, hybrid_attn_every=2, n_layers=4)
    if cfg.family == "ssm":
        kw.update(n_layers=4, slstm_layers=(1,), d_ff=0, head_dim=16)
    if cfg.family == "vlm":
        kw.update(n_patch_tokens=8, m_rope_sections=(2, 3, 3))
    if cfg.family == "audio":
        kw.update(n_enc_layers=2, n_layers=2)
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    return cfg.replace(name=cfg.name + "-reduced", **kw)
