"""Decoder-only LM on the paged KV plane (PyTorch counterpart of
``repro/models/transformer.py``, dense family).

The stacked ``(L, ...)`` block params keep JAX's leaf names and layouts;
``lax.scan`` over them becomes a Python loop over layers.  The arena is
``{"kp", "vp"}`` of shape ``(L, P, bt, K, hd)`` with the trash page at
``P - 1``.  The step functions update it IN PLACE (``index_put_``): what
JAX gets from ``donate_argnums`` on the arena, the port does directly, so
the arena never copies; they also return it, for symmetry with JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.layers import (
    ParamDef, attn_schema, mlp_apply, mlp_schema, paged_attn_apply,
    paged_prefill_attn_apply, rmsnorm, stack_schema,
)

_LATER = {"moe": "MoE and VLM on the paged plane",
          "vlm": "MoE and VLM on the paged plane",
          "hybrid": "the dense-cache plane and non-paged families",
          "ssm": "the dense-cache plane and non-paged families",
          "audio": "the dense-cache plane and non-paged families"}


def require_dense(cfg):
    """This slice of the port serves the dense family only."""
    if cfg.family != "dense":
        later = _LATER.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with the "
            f"slice for {later}")


# --------------------------------------------------------------------------
# Schema
# --------------------------------------------------------------------------
def _block_schema(cfg) -> Dict[str, Any]:
    D = cfg.d_model
    return {"ln1": ParamDef((D,), "zeros"),
            "attn": attn_schema(cfg),
            "ln2": ParamDef((D,), "zeros"),
            "mlp": mlp_schema(cfg)}


def lm_schema(cfg) -> Dict[str, Any]:
    require_dense(cfg)
    V, D = cfg.padded_vocab, cfg.d_model
    s: Dict[str, Any] = {
        "emb": ParamDef((V, D), scale=0.02),
        "final_norm": ParamDef((D,), "zeros"),
    }
    if not cfg.tie_embeddings:
        s["head"] = ParamDef((D, V))
    s["blocks"] = stack_schema(_block_schema(cfg), cfg.n_layers)
    return s


def layer_params(blocks, i: int):
    """Layer ``i``'s slice of the stacked block params (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# --------------------------------------------------------------------------
# Embedding / logits
# --------------------------------------------------------------------------
def _embed(params, tokens):
    return params["emb"][tokens.long()]


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        return x @ params["emb"].T
    return x @ params["head"]


def _ffn_block(bp, x, cfg):
    h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + mlp_apply(bp["mlp"], h)


# --------------------------------------------------------------------------
# Paged KV data plane
# --------------------------------------------------------------------------
def paged_blocks(max_len: int, block_tokens: int) -> int:
    """Blocks needed to cover ``max_len`` tokens."""
    return -(-max_len // block_tokens)


def lm_init_paged_cache(cfg, batch: int, max_len: int, block_tokens: int = 16,
                        dtype=None, device=None, frames=None):
    """Pooled KV arena: (L, P, bt, K, hd) pages shared by all slots through
    a block table.  P = batch * max_blocks real pages + one trash page
    (index P-1) that soaks up writes from inactive slots and pad columns."""
    require_dense(cfg)
    if dtype is None:
        dtype = getattr(torch, cfg.cache_dtype)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    real = frames if frames is not None \
        else batch * paged_blocks(max_len, block_tokens)
    shape = (cfg.n_layers, real + 1, block_tokens, K, hd)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def lm_paged_prefill_chunk(params, cfg, pages, tokens, block_tables,
                           ctx_lens, valid_lens):
    """Advance chunked prefill by one (bucket-padded) chunk per slot.

    tokens: (B, C) int32 — slot b's next ``valid_lens[b]`` prompt tokens at
    absolute positions [ctx_lens[b], ctx_lens[b] + valid); later columns
    are padding (computed, then routed to the trash page).  pages: the
    arena, updated in place; block_tables: (B, nb) int32, rows of slots
    not prefilling this step all < 0; ctx_lens, valid_lens: (B,) int32.
    Returns (logits (B, V) at each slot's last valid position, pages).
    """
    require_dense(cfg)
    B, C = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens)
    positions = ctx_lens.long()[:, None] + torch.arange(C, device=dev)[None]
    kp, vp = pages["kp"], pages["vp"]
    kns, vns = [], []
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        attn_out, (kn, vn) = paged_prefill_attn_apply(
            bp["attn"], h, cfg, kp[i], vp[i], block_tables, ctx_lens)
        x = x + attn_out
        x = _ffn_block(bp, x, cfg)
        kns.append(kn)
        vns.append(vn)

    # one fused in-place scatter of all layers' chunk KV into the arena;
    # padding columns (and slots whose table row is masked) -> trash page
    P, bt = kp.shape[1], kp.shape[2]
    nb = block_tables.shape[1]
    blk = (positions // bt).clamp(0, nb - 1)
    page_w = torch.gather(block_tables.long(), 1, blk)              # (B, C)
    valid = torch.arange(C, device=dev)[None, :] < valid_lens.long()[:, None]
    page_w = torch.where(valid & (page_w >= 0), page_w,
                         torch.full_like(page_w, P - 1))
    off = positions % bt
    kp[:, page_w, off] = torch.stack(kns)                 # (L, B, C, K, hd)
    vp[:, page_w, off] = torch.stack(vns)

    # logits at each slot's last valid position
    last = (valid_lens.long() - 1).clamp(0, C - 1)
    x_last = x[torch.arange(B, device=dev), last][:, None]      # (B, 1, D)
    x_last = rmsnorm(x_last, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x_last)[:, 0], pages


def lm_paged_decode_step(params, cfg, pages, tokens, block_tables, seq_lens):
    """One decode step over the paged KV pool; per-slot ragged lengths.

    tokens: (B, 1) int32; pages: the arena, updated in place;
    block_tables: (B, nb) int32 (< 0 = unallocated; nb only needs to cover
    max(seq_lens) + 1 tokens); seq_lens: (B,) int32 tokens resident (the
    new token lands at position seq_lens).  Returns (logits (B, V), pages).
    """
    require_dense(cfg)
    B = tokens.shape[0]
    dev = tokens.device
    x = _embed(params, tokens)
    kp, vp = pages["kp"], pages["vp"]
    kns, vns = [], []
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        attn_out, (kn, vn) = paged_attn_apply(
            bp["attn"], h, cfg, kp[i], vp[i], block_tables, seq_lens)
        x = x + attn_out
        x = _ffn_block(bp, x, cfg)
        kns.append(kn[:, 0])
        vns.append(vn[:, 0])

    # one fused in-place scatter of all layers' new KV into the arena
    P, bt = kp.shape[1], kp.shape[2]
    nb = block_tables.shape[1]
    lens = seq_lens.long()
    blk = (lens // bt).clamp(0, nb - 1)
    page_w = block_tables.long()[torch.arange(B, device=dev), blk]
    page_w = torch.where(page_w >= 0, page_w,
                         torch.full_like(page_w, P - 1))   # inactive -> trash
    off = lens % bt
    kp[:, page_w, off] = torch.stack(kns)                 # (L, B, K, hd)
    vp[:, page_w, off] = torch.stack(vns)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], pages
