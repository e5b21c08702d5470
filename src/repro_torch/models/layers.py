"""Core layers + parameter schemas (PyTorch counterpart of
``repro/models/layers.py``).

Numerics follow the JAX reference exactly: ``rmsnorm`` in f32 with
``(1 + w)`` (the ``rmsnorm`` kernel on a card); RoPE rotates the two
halves (not interleaved pairs) with frequencies computed in numpy f32,
and M-RoPE (qwen2-vl) takes each frequency's position from its section
of (t, h, w); ``silu`` in f32 cast back before the ``* u``; the new k/v cast to the
pool dtype before attention.
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
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, in x.dtype: the
    ``rmsnorm`` kernel on a card, the plain formula on the CPU."""
    return kops.rmsnorm(x, w, eps)


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


@functools.lru_cache(maxsize=16)
def _m_rope_sections_on(sections: Tuple[int, ...], device: torch.device):
    """(half,) section index of each frequency, on ``device`` once."""
    sec = np.concatenate([np.full(s, i) for i, s in enumerate(sections)])
    return torch.from_numpy(sec).long().to(device)


def apply_m_rope(x, pos3, sections: Tuple[int, ...], theta: float):
    """qwen2-vl M-RoPE.  x: (B, S, H, hd); pos3: (B, S, 3) int (t, h, w).

    ``sections`` partitions the half-dim; section i rotates with
    ``pos3[..., i]``.  With the three positions equal it computes RoPE's
    angles."""
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    sec = _m_rope_sections_on(tuple(sections), x.device)
    pos = pos3.float()[..., sec]                          # (B, S, half)
    ang = pos * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _rope(x, cfg, positions, pos3=None):
    """JAX's rotary choice in ``attn_apply`` and the paged paths: M-RoPE
    where the config has sections and ``pos3`` is given, else RoPE at
    ``positions``; nothing without a theta."""
    if cfg.rope_theta <= 0:
        return x
    if cfg.m_rope_sections and pos3 is not None:
        return apply_m_rope(x, pos3, cfg.m_rope_sections, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


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


def _project_q(p, x, cfg, positions, pos3=None):
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return _rope(q, cfg, positions, pos3)


def _project_kv(p, x, cfg):
    """k, v (B, S, K, hd) with biases and the k norm, before any rotary."""
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
    return k, v


def compute_kv(p, x, cfg, positions=None):
    """Project k, v for writing a KV cache (used by decode/prefill).  With
    M-RoPE sections, ``positions`` may be (B, S, 3) or 1-d / 2-d, which
    broadcasts to all three sections, as in JAX."""
    k, v = _project_kv(p, x, cfg)
    if cfg.rope_theta <= 0 or positions is None:
        return k, v
    if cfg.m_rope_sections:
        pos3 = positions if positions.dim() > 2 else \
            positions[..., None].expand(*k.shape[:2], 3)
        return apply_m_rope(k, pos3, cfg.m_rope_sections,
                            cfg.rope_theta), v
    return apply_rope(k, positions, cfg.rope_theta), v


def attn_apply(p, x, cfg, pos3=None):
    """Causal self-attention of a whole prompt (the prompt forward of
    one-shot prefill).

    x: (B, S, D) at positions [0, S).  Projections, q/k norm and the
    rotary (M-RoPE at ``pos3`` (B, S, 3) where the config has sections and
    it is given, else RoPE at [0, S), as JAX's ``attn_apply`` chooses) as
    in the paged paths, then ``kernels.ops.flash_attention`` (causal, with
    ``cfg.sliding_window``) over the prompt's own keys.  Returns
    (attn_out (B, S, D), (k, v) each (B, S, K, hd) in x.dtype), as JAX's
    ``attn_apply`` does.
    """
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    positions = torch.arange(S, device=x.device)
    q = _project_q(p, x, cfg, positions, pos3)
    k, v = _project_kv(p, x, cfg)
    k = _rope(k, cfg, positions, pos3)
    out = kops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True,
                               window=cfg.sliding_window)
    proj = out.reshape(B, S, H * hd) @ p["wo"]
    return proj, (k, v)


def gqa_attention(q, k, v, *, q_pos, k_pos, k_valid=None,
                  causal: bool = True, window: int = 0):
    """Plain GQA attention over a dense KV cache (JAX's ``gqa_attention``,
    jnp there and plain PyTorch here, on a card too).

    q: (B, S, H, hd); k, v: (B, T, K, hd) with H % K == 0; q_pos (B, S)
    and k_pos (B, T) absolute positions; k_valid: optional (B, T) bool of
    written cache slots; ``window`` > 0 keeps only keys with k_pos > q_pos
    - window.  Scores in f32, masked to -1e30, softmax in f32; the weights
    are rounded to v.dtype before P.V, as JAX does.  Returns (B, S, H, hd)
    in v.dtype.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) \
        * float(1.0 / np.sqrt(hd))
    mask = torch.ones((B, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def dense_decode_attn_apply(p, x, cfg, ck, cv, cur, write_idx, k_pos,
                            k_valid):
    """Single-token decode attention against one layer's dense cache,
    which it writes first (JAX's ``_decode_attn``: ``compute_kv``, the
    write at ``write_idx``, then ``attn_apply(kv=(ck, cv), k_pos,
    k_valid)`` with the config's window).

    x: (B, 1, D) normed at position ``cur`` (0-d int32 tensor); ck/cv:
    (B, T, K, hd), updated IN PLACE at ``write_idx`` (0-d, clamped to
    T - 1 as ``dynamic_update_slice`` clamps) with the new k/v cast to
    the cache dtype.  ``k_pos`` (T,) holds each cache row's position and
    ``k_valid`` (T,) which rows are written: ``arange(T)`` and
    ``k_pos <= cur`` for a linear cache, the ring's ``pos`` and
    ``pos >= 0`` under a sliding window.  Returns attn_out (B, 1, D).
    """
    B = x.shape[0]
    T = ck.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim
    qpos = cur.long().view(1, 1).expand(B, 1)
    # M-RoPE configs: every section at cur (JAX's pos3 for text decode)
    pos3 = qpos[..., None].expand(B, 1, 3) if cfg.m_rope_sections else None
    q = _project_q(p, x, cfg, qpos, pos3)
    knew, vnew = compute_kv(p, x, cfg,
                            positions=qpos if pos3 is None else pos3)
    idx = write_idx.long().clamp(max=T - 1).view(1)
    ck.index_copy_(1, idx, knew.to(ck.dtype))
    cv.index_copy_(1, idx, vnew.to(cv.dtype))
    out = gqa_attention(q, ck, cv, q_pos=qpos, k_pos=k_pos.long().expand(B, T),
                        k_valid=k_valid.expand(B, T),
                        window=cfg.sliding_window)
    return out.reshape(B, 1, H * hd) @ p["wo"]


def paged_attn_apply(p, x, cfg, k_pages, v_pages, block_tables, seq_lens,
                     pos3=None):
    """Single-token decode attention against a block-table-indexed KV pool.

    x: (B, 1, D); k_pages/v_pages: (P, bt, K, hd) one layer's arena;
    block_tables: (B, nb) int32; seq_lens: (B,) int32 tokens resident;
    ``pos3`` (B, 1, 3): the M-RoPE positions of an M-RoPE config (JAX
    passes the lengths broadcast).  The current token's k/v are projected
    here, folded into the softmax by the kernel, and returned (in the pool
    dtype) for the caller to scatter into the pool.  Returns (attn_out
    (B, 1, D), (k_new, v_new) each (B, 1, K, hd)).
    """
    B, S, D = x.shape
    assert S == 1, "paged attention is a decode (single-query) path"
    H, hd = cfg.n_heads, cfg.head_dim
    qpos = seq_lens[:, None]                             # (B, 1)
    q = _project_q(p, x, cfg, qpos, pos3)
    kn, vn = compute_kv(p, x, cfg, positions=pos3 if cfg.m_rope_sections
                        else qpos)
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
                             ctx_lens, pos3=None):
    """Chunk-resumable prefill attention against a block-table-indexed KV
    pool.

    x: (B, C, D) one prompt chunk per slot at absolute positions
    ``ctx_lens + [0, C)``; k_pages/v_pages: (P, bt, K, hd) one layer's
    arena holding the ``ctx_lens`` tokens of earlier chunks; ``pos3``
    (B, C, 3): an M-RoPE config's positions (JAX passes the absolute
    positions broadcast).  The chunk's own k/v are folded in by the kernel
    under the in-chunk causal mask and returned (in the pool dtype) for
    the caller to scatter.  Returns (attn_out (B, C, D), (k_new, v_new)
    each (B, C, K, hd)).
    """
    B, C, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    positions = ctx_lens[:, None] + torch.arange(
        C, device=x.device, dtype=ctx_lens.dtype)[None, :]   # (B, C)
    q = _project_q(p, x, cfg, positions, pos3)
    kn, vn = compute_kv(p, x, cfg, positions=pos3 if cfg.m_rope_sections
                        else positions)
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
