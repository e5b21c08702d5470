"""Core layers + parameter schemas (PyTorch counterpart of
``repro/models/layers.py``).

Numerics follow the JAX reference exactly: ``rmsnorm`` in f32 with
``(1 + w)``; RoPE rotates the two halves (not interleaved pairs) with
frequencies computed in numpy f32; ``silu`` in f32 cast back before the
``* u``; the new k/v cast to the pool dtype before attention.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


# --------------------------------------------------------------------------
# Param schema machinery
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones
    scale: Optional[float] = None


def stack_schema(schema, n: int):
    """Prepend a stacking dim (one entry per layer) to every ParamDef."""
    if isinstance(schema, ParamDef):
        return ParamDef((n,) + schema.shape, schema.init, schema.scale)
    return {k: stack_schema(v, n) for k, v in schema.items()}


def schema_leaves(schema, prefix: str = ""):
    """(path, ParamDef) pairs in a fixed (sorted) order."""
    if isinstance(schema, ParamDef):
        yield prefix, schema
        return
    for k in sorted(schema):
        yield from schema_leaves(schema[k], f"{prefix}/{k}" if prefix else k)


# elements of f32 scratch per normal-init draw: leaves fill one slice of
# their leading dim at a time, so the (L, D, F) MLP stacks never
# materialise a full f32 copy
_INIT_CHUNK = 1 << 26


def _fill_normal(leaf: torch.Tensor, scale: float,
                 gen: torch.Generator):
    rows = leaf.shape[0] if leaf.dim() else 1
    per_row = max(1, leaf.numel() // max(rows, 1))
    step = max(1, _INIT_CHUNK // per_row)
    flat = leaf.view(rows, -1) if leaf.dim() else leaf.view(1, 1)
    for i in range(0, rows, step):
        blk = flat[i:i + step]
        tmp = torch.randn(blk.shape, generator=gen, device=leaf.device,
                          dtype=torch.float32)
        blk.copy_(tmp.mul_(scale))


def init_params(schema, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Any:
    """Materialise a schema: normal(0, 1) * scale with scale =
    1/sqrt(fan_in) unless the ParamDef names one, zeros/ones as named.
    Draws come from ``generator`` leaf by leaf in sorted path order, so
    a seed fixes the params on a given device.  (They are not JAX's
    numbers: tests carry the JAX params across with ``models.convert``.)"""
    out: Dict[str, Any] = {}
    for path, p in schema_leaves(schema):
        if p.init == "zeros":
            arr = torch.zeros(p.shape, dtype=dtype, device=device)
        elif p.init == "ones":
            arr = torch.ones(p.shape, dtype=dtype, device=device)
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            scale = p.scale if p.scale is not None \
                else 1.0 / np.sqrt(max(fan_in, 1))
            arr = torch.empty(p.shape, dtype=dtype, device=device)
            _fill_normal(arr, float(scale), generator)
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return out


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------
def rmsnorm(x, w, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def _rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """The numpy-f32 frequencies, copied to ``device`` once: a host-to-
    device copy from pageable memory waits for the stream, so copying per
    call would serialise every layer of a step with the host."""
    return torch.from_numpy(_rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Schemas for the attention and MLP blocks
# --------------------------------------------------------------------------
def attn_schema(cfg) -> Dict[str, ParamDef]:
    D, Q, KV, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    s: Dict[str, ParamDef] = {
        "wq": ParamDef((D, Q)),
        "wk": ParamDef((D, KV)),
        "wv": ParamDef((D, KV)),
        "wo": ParamDef((Q, D)),
    }
    if cfg.use_bias:
        s["bq"] = ParamDef((Q,), "zeros")
        s["bk"] = ParamDef((KV,), "zeros")
        s["bv"] = ParamDef((KV,), "zeros")
    if cfg.use_qk_norm:
        s["q_norm"] = ParamDef((hd,), "zeros")
        s["k_norm"] = ParamDef((hd,), "zeros")
    return s


def mlp_schema(cfg, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": ParamDef((D, F_)),
        "wu": ParamDef((D, F_)),
        "wd": ParamDef((F_, D)),
    }


def _check_rope(cfg):
    if cfg.m_rope_sections:
        raise NotImplementedError("M-RoPE (vlm family) is a later slice of "
                                  "the port (MoE and VLM on the paged plane)")


def _project_q(p, x, cfg, positions):
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def compute_kv(p, x, cfg, positions=None):
    """Project k, v for writing a KV cache (used by decode/prefill)."""
    _check_rope(cfg)
    B, S, _ = x.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.use_qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0 and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def paged_attn_apply(p, x, cfg, k_pages, v_pages, block_tables, seq_lens):
    """Single-token decode attention against a block-table-indexed KV pool.

    x: (B, 1, D); k_pages/v_pages: (P, bt, K, hd) one layer's arena;
    block_tables: (B, nb) int32; seq_lens: (B,) int32 tokens resident.
    The current token's k/v are projected here, folded into the softmax by
    the kernel, and returned (in the pool dtype) for the caller to
    scatter into the pool.  Returns (attn_out (B, 1, D), (k_new, v_new)
    each (B, 1, K, hd)).
    """
    B, S, D = x.shape
    assert S == 1, "paged attention is a decode (single-query) path"
    _check_rope(cfg)
    H, hd = cfg.n_heads, cfg.head_dim
    qpos = seq_lens[:, None]                             # (B, 1)
    q = _project_q(p, x, cfg, qpos)
    kn, vn = compute_kv(p, x, cfg, positions=qpos)
    # kv is stored (and attended) in the pool dtype
    kn = kn.to(k_pages.dtype)
    vn = vn.to(v_pages.dtype)
    out = kops.paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                               block_tables, seq_lens,
                               kn[:, 0].contiguous(), vn[:, 0].contiguous(),
                               window=cfg.sliding_window)
    proj = out.reshape(B, 1, H * hd) @ p["wo"]
    return proj, (kn, vn)


def paged_prefill_attn_apply(p, x, cfg, k_pages, v_pages, block_tables,
                             ctx_lens):
    """Chunk-resumable prefill attention against a block-table-indexed KV
    pool.

    x: (B, C, D) one prompt chunk per slot at absolute positions
    ``ctx_lens + [0, C)``; k_pages/v_pages: (P, bt, K, hd) one layer's
    arena holding the ``ctx_lens`` tokens of earlier chunks.  The chunk's
    own k/v are folded in by the kernel under the in-chunk causal mask and
    returned (in the pool dtype) for the caller to scatter.  Returns
    (attn_out (B, C, D), (k_new, v_new) each (B, C, K, hd)).
    """
    B, C, D = x.shape
    _check_rope(cfg)
    H, hd = cfg.n_heads, cfg.head_dim
    positions = ctx_lens[:, None] + torch.arange(
        C, device=x.device, dtype=ctx_lens.dtype)[None, :]   # (B, C)
    q = _project_q(p, x, cfg, positions)
    kn, vn = compute_kv(p, x, cfg, positions=positions)
    kn = kn.to(k_pages.dtype).contiguous()
    vn = vn.to(v_pages.dtype).contiguous()
    out = kops.paged_prefill_attention(q.contiguous(), k_pages, v_pages,
                                       block_tables, ctx_lens, kn, vn,
                                       window=cfg.sliding_window)
    proj = out.reshape(B, C, H * hd) @ p["wo"]
    return proj, (kn, vn)


def mlp_apply(p, x):
    g = x @ p["wg"]
    u = x @ p["wu"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["wd"]
