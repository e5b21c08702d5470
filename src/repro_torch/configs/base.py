"""Model/run configuration for the repro framework.

One ``ModelConfig`` covers every assigned architecture family:
dense / moe / hybrid (mamba+shared-attn) / ssm (xLSTM) / vlm / audio (enc-dec).

The FULL configs are exercised only via the dry-run (ShapeDtypeStruct, no
allocation); ``reduced()`` returns a smoke-test-sized config of the same
family for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

VOCAB_PAD_MULTIPLE = 256


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # "capacity": per-group capacity C = ceil(k*Tl/E * cf) with local drops
    # (training default — MaxText-style).  "dropless": C = Tl (top_k
    # indices are distinct per token, so no expert can receive more), so
    # no assignment can ever be dropped and routing is a pure per-token
    # function — invariant to chunk splits, pad rows, and co-resident
    # batch composition (the serving default for moe: chunked bucketed
    # prefill and deterministic decode need it).
    moe_routing: str = "capacity"

    # --- SSM / Mamba2 ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # hybrid: shared attention block applied every `hybrid_attn_every` layers
    hybrid_attn_every: int = 0

    # --- xLSTM ---
    slstm_layers: Tuple[int, ...] = ()

    # --- attention flavor ---
    sliding_window: int = 0          # 0 -> full attention
    rope_theta: float = 10_000.0
    m_rope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (half-dim sections)
    attn_logit_softcap: float = 0.0
    use_qk_norm: bool = False

    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500           # stub conv frontend output length

    # --- vlm ---
    n_patch_tokens: int = 0          # stub vision frontend tokens merged at front

    # --- common ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    use_bias: bool = False

    # --- numerics / execution ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"    # decode KV cache / paged arena storage
    remat_policy: str = "full"       # full | dots | none
    scan_layers: bool = True
    attention_impl: str = "xla"      # xla | pallas (pallas = interpret-mode tests)
    grad_accum: int = 1              # microbatch scan inside train_step
    q_chunk: int = 0                 # 0 = auto (blocked attn for seq>=8192)

    # --- beyond-paper perf knobs (see EXPERIMENTS.md §Perf) ---
    fuse_attn_mlp: bool = False          # single fused residual block
    local_moe_dispatch: bool = False     # shard_map local dispatch (collective saver)
    seq_shard_activations: bool = True   # legacy alias for act_shard="embed"
    act_shard: str = "embed"             # embed | seq (Megatron-SP) | none
    train_act_shard: str = ""            # override for train_step ("" = same)
    infer_weight_layout: bool = False    # serving: no FSDP dim on weights
    pin_intermediates: bool = True       # layout pins on projections (§Perf)

    # --- cohet integration ---
    pool_policy: str = "hbm"         # hbm | host_offload_opt | cxl_tier

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.moe_routing not in ("capacity", "dropless"):
            raise ValueError(f"moe_routing must be 'capacity' or 'dropless', "
                             f"got {self.moe_routing!r}")

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return max(1, self.d_inner // self.ssm_head_dim)

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can run long_500k (sub-quadratic sequence mixing)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode step (whisper is enc-dec)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------- parameter counting (for roofline MODEL_FLOPS) ----------
    def param_counts(self) -> dict:
        """Returns dict(total=..., active=...) of parameter counts (no dry-run)."""
        D, V = self.d_model, self.padded_vocab
        emb = V * D
        head = 0 if self.tie_embeddings else V * D
        per_attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
        per_mlp = 3 * D * self.d_ff if self.d_ff else 0
        per_norms = 2 * D

        def moe_layer():
            router = D * self.n_experts
            experts = self.n_experts * 3 * D * self.d_ff_expert
            active = self.top_k * 3 * D * self.d_ff_expert + router
            return router + experts, active

        def mamba_layer():
            di, s, h = self.d_inner, self.ssm_state, self.n_ssm_heads
            in_p = D * (2 * di + 2 * s + h)
            conv = di * self.conv_width
            out_p = di * D
            extra = h * 2 + di  # A_log, D, dt_bias-ish
            return in_p + conv + out_p + extra + D

        total = emb + head + D  # final norm
        active = emb + head + D
        if self.family in ("dense", "vlm"):
            per = per_attn + per_mlp + per_norms
            total += self.n_layers * per
            active += self.n_layers * per
        elif self.family == "moe":
            moe_tot, moe_act = moe_layer()
            total += self.n_layers * (per_attn + per_norms + moe_tot)
            active += self.n_layers * (per_attn + per_norms + moe_act)
        elif self.family == "hybrid":
            m = mamba_layer()
            total += self.n_layers * m + (per_attn + per_mlp + per_norms)
            active += self.n_layers * m
            n_app = (self.n_layers + self.hybrid_attn_every - 1) // self.hybrid_attn_every
            active += n_app * (per_attn + per_mlp + per_norms)
        elif self.family == "ssm":
            # mLSTM/sLSTM blocks: qkv-ish projections + gates
            hd = self.head_dim
            per_m = 4 * D * D + 2 * self.n_heads * D + 2 * D  # q,k,v,o + i,f gates + norms
            total += self.n_layers * per_m
            active += self.n_layers * per_m
        elif self.family == "audio":
            per = per_attn + per_mlp + per_norms
            dec = self.n_layers * (per + per_attn + D)   # + cross-attn
            enc = self.n_enc_layers * per
            total += dec + enc
            active += dec + enc
        return {"total": int(total), "active": int(active)}


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether this (arch x shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic mixing (skip per brief)"
    return True, ""


# ---------------------------------------------------------------- registry
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # late import of arch modules
        from repro_torch import configs as _c  # noqa
        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_arch_names():
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)
