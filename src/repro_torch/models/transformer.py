"""Decoder-only LM (PyTorch counterpart of ``repro/models/transformer.py``):
the dense and moe families on the paged KV plane (the exact-length prompt
forward of one-shot prefill, ``lm_prefill``, and its page write, chunked
prefill, paged decode; with a sliding window too, whose one-shot rows come
ring-packed as in JAX), and the zamba2-style hybrid family on the
dense-cache plane (``lm_init_cache``, ``lm_prefill`` with ``max_len``,
``lm_decode_step``).

The stacked ``(L, ...)`` block params keep JAX's leaf names and layouts
(hybrid: ``mamba_groups`` stacked ``(n_groups, every, ...)``,
``mamba_tail`` ``(tail, ...)``, one ``shared`` attention block);
``lax.scan`` over them becomes a Python loop over layers.  The arena is
``{"kp", "vp"}`` of shape ``(L, P, bt, K, hd)`` with the trash page at
``P - 1``.  The step functions update the arena, or the dense cache, IN
PLACE (``index_put_`` / ``index_copy_``): what JAX gets from
``donate_argnums``, the port does directly, so neither ever copies; they
also return it, for symmetry with JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ParamDef, attn_apply, attn_schema, dense_decode_attn_apply, mlp_apply,
    mlp_schema, paged_attn_apply, paged_prefill_attn_apply, rmsnorm,
    stack_schema,
)

_PAGED_FAMILIES = ("dense", "moe")
_DENSE_PLANE_FAMILIES = ("hybrid",)
_LATER = {"vlm": "VLM on the paged plane",
          "ssm": "xLSTM with continuous admission (non-paged families)",
          "audio": "whisper (encoder-decoder, non-paged families)"}


def require_ported_family(cfg):
    """The port serves the dense and moe families on the paged plane and
    the hybrid family on the dense-cache plane."""
    if cfg.family not in _PAGED_FAMILIES + _DENSE_PLANE_FAMILIES:
        later = _LATER.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with the "
            f"slice for {later}")


def require_paged_family(cfg):
    """Guard of the paged-plane entry points: dense and moe."""
    require_ported_family(cfg)
    if cfg.family not in _PAGED_FAMILIES:
        raise ValueError(f"family {cfg.family!r} has no paged KV path (its "
                         f"cache is not a uniform KV stack): it serves on "
                         f"the dense-cache plane, as in JAX")


def require_dense_plane_family(cfg):
    """Guard of the dense-cache entry points: the hybrid family.  The
    dense and moe families' dense plane (bucketed prefill, the SWA ring)
    is a later slice."""
    require_ported_family(cfg)
    if cfg.family not in _DENSE_PLANE_FAMILIES:
        what = "the sliding-window ring (cache['pos']) of the dense " \
            "(slots, max_len) KV cache" if cfg.sliding_window else \
            "the dense (slots, max_len) KV cache"
        raise NotImplementedError(
            f"{what} of family {cfg.family!r} is not ported yet: it comes "
            f"with the port's slice for the dense-cache plane of the dense "
            f"family")


# --------------------------------------------------------------------------
# Schema
# --------------------------------------------------------------------------
def _block_schema(cfg) -> Dict[str, Any]:
    D = cfg.d_model
    s: Dict[str, Any] = {"ln1": ParamDef((D,), "zeros"),
                         "attn": attn_schema(cfg),
                         "ln2": ParamDef((D,), "zeros")}
    if cfg.family == "moe":
        s["moe"] = moe_mod.moe_schema(cfg)
    else:
        s["mlp"] = mlp_schema(cfg)
    return s


def hybrid_layout(cfg) -> Tuple[int, int, int]:
    """(n_groups, group_size, tail) for zamba2-style hybrids."""
    every = cfg.hybrid_attn_every
    n_groups = cfg.n_layers // every
    tail = cfg.n_layers - n_groups * every
    return n_groups, every, tail


def _mamba_block_schema(cfg) -> Dict[str, Any]:
    return {"norm": ParamDef((cfg.d_model,), "zeros"),
            **ssm_mod.mamba_schema(cfg)}


def lm_schema(cfg) -> Dict[str, Any]:
    require_ported_family(cfg)
    V, D = cfg.padded_vocab, cfg.d_model
    s: Dict[str, Any] = {
        "emb": ParamDef((V, D), scale=0.02),
        "final_norm": ParamDef((D,), "zeros"),
    }
    if not cfg.tie_embeddings:
        s["head"] = ParamDef((D, V))
    if cfg.family == "hybrid":
        ng, every, tail = hybrid_layout(cfg)
        mb = _mamba_block_schema(cfg)
        if ng > 0:
            s["mamba_groups"] = stack_schema(stack_schema(mb, every), ng)
        if tail:
            s["mamba_tail"] = stack_schema(mb, tail)
        s["shared"] = _block_schema(cfg)
    else:
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
    """Pre-norm FFN with residual.  The serving steps drop the MoE aux
    losses, which the JAX steps compute and discard."""
    h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        return x + moe_mod.moe_apply(bp["moe"], h, cfg)
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
    require_paged_family(cfg)
    if dtype is None:
        dtype = getattr(torch, cfg.cache_dtype)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    real = frames if frames is not None \
        else batch * paged_blocks(max_len, block_tokens)
    shape = (cfg.n_layers, real + 1, block_tokens, K, hd)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def lm_kv_migrate(near, far, dem_src, dem_dst, pro_src, pro_dst):
    """One fused near<->far migration event over two KV arenas, in place.

    near/far: {"kp", "vp"} arenas (L, P_near/P_far, bt, K, hd);
    dem_src/dem_dst: (D,) int — demotions copy near frame dem_src[i] into
    far frame dem_dst[i]; pro_src/pro_dst: (U,) int — promotions copy far
    frame pro_src[i] into near frame pro_dst[i].  Ragged event sizes are
    padded with trash->trash self-copies (duplicate indices: which write
    lands is undefined, and the trash frames are never read meaningfully).

    Gather-first: all four source blocks are copied out of the arenas
    before either arena is written, so a far frame freed by a promotion
    may take a demotion, and a near frame freed by a demotion may take a
    promotion, in the same event (the swap case when both tiers are
    full).  Returns (near, far).
    """
    dem_src, dem_dst = dem_src.long(), dem_dst.long()
    pro_src, pro_dst = pro_src.long(), pro_dst.long()
    moved = {name: (near[name][:, dem_src], far[name][:, pro_src])
             for name in ("kp", "vp")}
    for name, (dem_rows, pro_rows) in moved.items():
        far[name].index_copy_(1, dem_dst, dem_rows)
        near[name].index_copy_(1, pro_dst, pro_rows)
    return near, far


# --------------------------------------------------------------------------
# One-shot prefill: exact-length prompt forward, then one page write
# --------------------------------------------------------------------------
def _attn_block(bp, x, cfg):
    """Pre-norm causal self-attention of the whole prompt, with residual;
    returns (x, (k, v))."""
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    attn_out, kv = attn_apply(bp["attn"], h, cfg)
    return x + attn_out, kv


def _mamba_layer(mp, x, cfg):
    """Pre-norm Mamba2 layer over the prompt, with residual; returns
    (x, decode state)."""
    y, st = ssm_mod.mamba_apply(mp, rmsnorm(x, mp["norm"], cfg.norm_eps),
                                cfg, return_state=True)
    return x + y, st


def _hybrid_forward(params, cfg, x):
    """zamba2 groups of [shared attention block + ``every`` Mamba2 layers],
    then the tail layers.  Returns (x, group k/v lists, per-layer states
    in layer order)."""
    ng, every, tail = hybrid_layout(cfg)
    shared = params["shared"]
    ks, vs, states = [], [], []
    for g in range(ng):
        x, (k, v) = _attn_block(shared, x, cfg)
        x = _ffn_block(shared, x, cfg)
        ks.append(k)
        vs.append(v)
        gp = layer_params(params["mamba_groups"], g)
        for j in range(every):
            x, st = _mamba_layer(layer_params(gp, j), x, cfg)
            states.append(st)
    for j in range(tail):
        x, st = _mamba_layer(layer_params(params["mamba_tail"], j), x, cfg)
        states.append(st)
    return x, ks, vs, states


def _pack_kv(kv, B, T, cfg, like):
    """Stacked (n, B, S, K, hd) rows sliced or zero-padded to T positions
    (a prompt longer than T keeps its last T); no groups -> an empty
    (0, B, T, K, hd) bf16 stack, as in JAX."""
    if not kv:
        return torch.zeros((0, B, T, cfg.n_kv_heads, cfg.head_dim),
                           dtype=torch.bfloat16, device=like.device)
    k = torch.stack(kv)
    S = k.shape[2]
    if S > T:
        return k[:, :, S - T:]
    return F.pad(k, (0, 0, 0, 0, 0, T - S))


def lm_prefill(params, cfg, tokens, max_len=None):
    """Forward over whole prompts at their exact length, returning
    (logits (B, V) at position S - 1, cache).

    tokens: (B, S) int32, all rows of one length.  Attention runs causal
    over the prompt (``layers.attn_apply``: the ``flash_attention`` kernel
    on a card), each Mamba2 layer its chunked scan (``ssm.mamba_apply``:
    the ``ssd_scan`` kernel on a card); the final norm runs over the whole
    sequence, as JAX's ``lm_hidden`` does.

    Dense and moe (paged plane, ``max_len=None`` only): cache {"k", "v":
    (L, B, S, K, hd) in the compute dtype, "cur": S as a 0-d int32}.  With
    a sliding window W the cache keeps the last T = min(W, S) positions in
    JAX's ring order (row i holds the position p with p % T == i) and adds
    "pos": (T,) int32, the position each row holds.
    Under capacity routing the MoE layers dispatch the whole (B, S) group
    at once, as in JAX.  Hybrid (dense-cache plane): {"k", "v": (n_groups,
    B, T, K, hd) with T = max_len or S, "ssm": (n_layers, B, h, hd, S) f32,
    "conv": (n_layers, B, w - 1, di) bf16, "cur": S}.
    """
    require_ported_family(cfg)
    if max_len is not None:
        require_dense_plane_family(cfg)
    B, S = tokens.shape
    x = _embed(params, tokens)
    cur = torch.full((), S, dtype=torch.int32, device=tokens.device)
    if cfg.family == "hybrid":
        x, ks, vs, states = _hybrid_forward(params, cfg, x)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = _logits(params, cfg, x[:, -1:])[:, 0]
        T = max_len or S
        return logits, {"k": _pack_kv(ks, B, T, cfg, x),
                        "v": _pack_kv(vs, B, T, cfg, x),
                        "ssm": torch.stack([st["ssm"] for st in states]),
                        "conv": torch.stack([st["conv"] for st in states]),
                        "cur": cur}
    ks, vs = [], []
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        x, (k, v) = _attn_block(bp, x, cfg)
        x = _ffn_block(bp, x, cfg)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "cur": cur}
    if cfg.sliding_window:
        T = min(cfg.sliding_window, S)
        # ring invariant: row i holds the position p in [S - T, S) with
        # p % T == i, so row i reads prompt position ring[i]
        ring = torch.arange(S - T, S, device=x.device)
        ring = ring[torch.argsort(ring % T)]
        src = ring - (S - T)
        cache["k"] = cache["k"][:, :, S - T:][:, :, src]
        cache["v"] = cache["v"][:, :, S - T:][:, :, src]
        cache["pos"] = ring.to(torch.int32)
    return logits, cache


def lm_paged_prefill_write(cfg, pages, k_rows, v_rows, block_ids,
                           prompt_len: int, skip_tokens: int = 0):
    """Scatter an admission group's prefilled KV into its pool pages.

    k_rows/v_rows: (L, G, T, K, hd) — the G rows of an ``lm_prefill``
    cache (T = prompt_len, or the ring-packed window of a sliding-window
    config); block_ids: (G * nb,) int page ids, row-major (slot 0's nb
    blocks, then slot 1's, ...), each run in position order.  One fused
    in-place write installs the whole group, cast to the arena dtype, and
    touches only the admitted slots' pages; returns the arena.  Ring rows
    (T < prompt_len) are unpermuted to position order and land at
    positions [S - T, S), zeros before: the window keeps those dead.

    ``skip_tokens`` (block-aligned, inside the prompt) drops the leading
    positions, whose pages a prefix-cache hit shares with other requests;
    ``block_ids`` then covers only the tail blocks.
    """
    L, G, T, K, hd = k_rows.shape
    bt = pages["kp"].shape[2]
    nb = block_ids.shape[0] // G
    S = prompt_len
    W = cfg.sliding_window
    if skip_tokens:
        if W and S > T:
            raise ValueError("skip_tokens is incompatible with ring-packed "
                             "sliding-window prefill rows")
        if skip_tokens % bt or not 0 < skip_tokens < S:
            raise ValueError(f"skip_tokens must be a block-aligned count "
                             f"inside the prompt, got {skip_tokens}/{S}")
        k_rows = k_rows[:, :, skip_tokens:]
        v_rows = v_rows[:, :, skip_tokens:]
        S = S - skip_tokens
        T = T - skip_tokens
    if W and S > T:
        # ring row i holds position p with p % T == i: unpermute to
        # position order and place at [S - T, S)
        src = torch.arange(S - T, S, device=k_rows.device) % T
        k_rows = F.pad(k_rows[:, :, src], (0, 0, 0, 0, S - T, 0))
        v_rows = F.pad(v_rows[:, :, src], (0, 0, 0, 0, S - T, 0))
    kp, vp = pages["kp"], pages["vp"]
    pad = (0, 0, 0, 0, 0, nb * bt - S)       # right-pad positions to nb * bt
    ids = block_ids.long()
    kp[:, ids] = F.pad(k_rows, pad).reshape(L, G * nb, bt, K, hd).to(kp.dtype)
    vp[:, ids] = F.pad(v_rows, pad).reshape(L, G * nb, bt, K, hd).to(vp.dtype)
    return pages


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
    require_paged_family(cfg)
    if cfg.family == "moe" and cfg.moe_routing != "dropless":
        # pad columns and chunk boundaries would shift capacity-factor
        # expert drops; only dropless routing is chunk/pad-invariant
        raise ValueError("chunked prefill for moe requires "
                         "cfg.moe_routing='dropless'")
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
    require_paged_family(cfg)
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


# --------------------------------------------------------------------------
# Dense-cache plane (hybrid family)
# --------------------------------------------------------------------------
def lm_init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero-initialised dense decode cache: {"k", "v": (n_groups, batch, T,
    K, hd) and "conv": (n_layers, batch, w - 1, di) in ``cfg.cache_dtype``,
    "ssm": (n_layers, batch, h, hd, S) f32, "cur": 0 as a 0-d int32}."""
    require_dense_plane_family(cfg)
    if dtype is None:
        dtype = getattr(torch, cfg.cache_dtype)
    ng, _, _ = hybrid_layout(cfg)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    h, hs, S = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    L = cfg.n_layers
    kv = (ng, batch, max_len, K, hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "ssm": torch.zeros((L, batch, h, hs, S), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((L, batch, cfg.conv_width - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "cur": torch.zeros((), dtype=torch.int32, device=device)}


def lm_decode_step(params, cfg, cache, tokens):
    """tokens: (B, 1) int32 -> (logits (B, V), cache).  Every slot decodes
    at the shared write index ``cur``.

    The cache is updated IN PLACE (each group's k/v at ``cur``, each
    layer's ssm state) and returned with ``cur + 1``.  The conv leaf comes
    back bf16, as JAX's does: a bf16 leaf is written in place, a leaf of
    another dtype (an f32 cache before its first step) is replaced by a
    bf16 one.
    """
    require_dense_plane_family(cfg)
    ng, every, tail = hybrid_layout(cfg)
    cur = cache["cur"]
    x = _embed(params, tokens)
    shared = params["shared"]
    ssm, conv = cache["ssm"], cache["conv"]
    new_conv = conv if conv.dtype == torch.bfloat16 \
        else torch.empty(conv.shape, dtype=torch.bfloat16, device=conv.device)

    def mamba(mp, x, i):
        h = rmsnorm(x, mp["norm"], cfg.norm_eps)
        y, st = ssm_mod.mamba_decode_step(
            mp, h, {"ssm": ssm[i], "conv": conv[i]}, cfg)
        ssm[i].copy_(st["ssm"])
        new_conv[i].copy_(st["conv"])
        return x + y

    for g in range(ng):
        h = rmsnorm(x, shared["ln1"], cfg.norm_eps)
        x = x + dense_decode_attn_apply(shared["attn"], h, cfg,
                                        cache["k"][g], cache["v"][g], cur)
        x = _ffn_block(shared, x, cfg)
        gp = layer_params(params["mamba_groups"], g)
        for j in range(every):
            x = mamba(layer_params(gp, j), x, g * every + j)
    for j in range(tail):
        x = mamba(layer_params(params["mamba_tail"], j), x, ng * every + j)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], {
        "k": cache["k"], "v": cache["v"], "ssm": ssm, "conv": new_conv,
        "cur": cur + 1}
