"""Decoder-only LM (PyTorch counterpart of ``repro/models/transformer.py``):
the dense, moe and vlm families on the paged KV plane (the exact-length
prompt forward of one-shot prefill, ``lm_prefill``, and its page write,
chunked prefill, paged decode; with a sliding window too, whose one-shot
rows come ring-packed as in JAX), and every ported family on the
dense-cache plane (``lm_init_cache``, ``lm_prefill`` with ``max_len`` and,
for bucketed prefill, ``valid_len``, ``lm_decode_step``): the dense, moe
and vlm families' (L, B, T, K, hd) KV cache, a sliding-window ring under a
window, the zamba2-style hybrid's cache of group KV and Mamba2 states, and
the xLSTM (ssm) family's per-layer recurrent states.  The vlm family
(qwen2-vl) rotates with M-RoPE: ``lm_prefill`` takes image rows
(``vis_embeds``) and (t, h, w) positions (``pos_ids``); the serving steps
give all three sections the token's position, as JAX's do.

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
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (
    ParamDef, attn_apply, attn_schema, dense_decode_attn_apply, mlp_apply,
    mlp_schema, paged_attn_apply, paged_prefill_attn_apply, rmsnorm,
    stack_schema,
)

# the families whose whole cache is a uniform causal (L, B, T, K, hd) KV
# stack: they page, and right-padded (bucketed) prefill is exact for them
_PAGED_FAMILIES = ("dense", "moe", "vlm")
_LATER = {"audio": "whisper (encoder-decoder, non-paged families)"}


def require_ported_family(cfg):
    """The port serves the dense, moe and vlm families on the paged and the
    dense-cache plane, and the hybrid and ssm families on the dense-cache
    plane."""
    if cfg.family not in _PAGED_FAMILIES + ("hybrid", "ssm"):
        later = _LATER.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with the "
            f"slice for {later}")


def require_paged_family(cfg):
    """Guard of the paged-plane entry points: dense, moe and vlm."""
    require_ported_family(cfg)
    if cfg.family not in _PAGED_FAMILIES:
        raise ValueError(f"family {cfg.family!r} has no paged KV path (its "
                         f"cache is not a uniform KV stack): it serves on "
                         f"the dense-cache plane, as in JAX")


def kv_cache_len(cfg, seq_len: int) -> int:
    """Rows of a dense KV cache for ``seq_len`` tokens: the window under a
    sliding window (the ring), else every position."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


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
    elif cfg.family == "ssm":
        # per-layer dicts (12 heterogeneous layers, unrolled in JAX), each
        # with a marker leaf naming its kind
        layers = {}
        for i in range(cfg.n_layers):
            kind = _layer_kind(cfg, i)
            sch = xl.slstm_schema(cfg) if kind == "slstm" \
                else xl.mlstm_schema(cfg)
            layers[f"l{i:02d}"] = {"kind_" + kind: ParamDef((1,), "zeros"),
                                   "norm": ParamDef((D,), "zeros"), **sch}
        s["layers"] = layers
    else:
        s["blocks"] = stack_schema(_block_schema(cfg), cfg.n_layers)
    return s


def _layer_kind(cfg, i: int) -> str:
    return "slstm" if i in cfg.slstm_layers else "mlstm"


def layer_params(blocks, i: int):
    """Layer ``i``'s slice of the stacked block params (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# --------------------------------------------------------------------------
# Embedding / logits
# --------------------------------------------------------------------------
def _embed(params, tokens, vis_embeds=None):
    """Token rows; a vlm prompt's image rows ``vis_embeds`` (B, P, D)
    replace its first P rows (JAX's ``_embed``)."""
    x = params["emb"][tokens.long()]
    if vis_embeds is not None:
        P = vis_embeds.shape[1]
        x = torch.cat([vis_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


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
def _attn_block(bp, x, cfg, pos3=None):
    """Pre-norm causal self-attention of the whole prompt, with residual;
    returns (x, (k, v))."""
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    attn_out, kv = attn_apply(bp["attn"], h, cfg, pos3)
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


def _ssm_forward(params, cfg, x):
    """The xLSTM layers over the prompt: pre-norm (the ``rmsnorm`` kernel
    on a card), the mLSTM or sLSTM block from a zero state, residual.
    Returns (x, {lNN: final state})."""
    states = {}
    for i in range(cfg.n_layers):
        key = f"l{i:02d}"
        lp = params["layers"][key]
        h = rmsnorm(x, lp["norm"], cfg.norm_eps)
        apply = xl.slstm_apply if _layer_kind(cfg, i) == "slstm" \
            else xl.mlstm_apply
        y, states[key] = apply(lp, h, cfg)
        x = x + y
    return x, states


def _pack_kv(kv, B, T, cfg, like):
    """Stacked (n, B, S, K, hd) rows sliced or zero-padded to T positions
    (a prompt longer than T keeps its last T); no groups (hybrid) -> an
    empty (0, B, T, K, hd) bf16 stack, as in JAX."""
    if not kv:
        return torch.zeros((0, B, T, cfg.n_kv_heads, cfg.head_dim),
                           dtype=torch.bfloat16, device=like.device)
    k = torch.stack(kv)
    S = k.shape[2]
    if S >= T:
        return k[:, :, S - T:]
    return F.pad(k, (0, 0, 0, 0, 0, T - S))


def _ring_pack(k, v, S, T):
    """JAX's sliding-window ring over a packed (L, B, T, K, hd) pair whose
    row j holds position S - n + j (n = min(S, T)): row i of the ring
    holds the position p in [S - n, S) with p % T == i, and ``pos[i]`` is
    p, or -1 for a row no position reaches (S < T; the row then copies
    row 0, as JAX's gather does).  Returns (k, v, pos)."""
    n = min(S, T)
    pos = torch.arange(S - n, S, device=k.device)
    ring = torch.full((T,), -1, dtype=torch.int64, device=k.device)
    ring[pos % T] = pos
    src = torch.where(ring >= 0, (ring - (S - n)).clamp(min=0),
                      torch.zeros_like(ring))
    return k[:, :, src], v[:, :, src], ring.to(torch.int32)


def lm_prefill(params, cfg, tokens, max_len=None, valid_len=None, *,
               vis_embeds=None, pos_ids=None):
    """Forward over whole prompts, returning (logits (B, V) at the last
    position, cache).

    tokens: (B, S) int32, all rows of one length.  Attention runs causal
    over the prompt (``layers.attn_apply``: the ``flash_attention`` kernel
    on a card), each Mamba2 layer its chunked scan (``ssm.mamba_apply``:
    the ``ssd_scan`` kernel on a card); the final norm runs over the whole
    sequence, as JAX's ``lm_hidden`` does.

    Dense, moe and vlm: cache {"k", "v": (L, B, T, K, hd) in the compute
    dtype,
    "cur": S as a 0-d int32} with T = ``kv_cache_len(cfg, max_len or
    S)``: the KV zero-padded to T rows, or its last T positions.  With a
    sliding window W the rows come in JAX's ring order (row i holds the
    position p with p % T == i) and "pos": (T,) int32 holds each row's
    position, -1 where none: the paged plane's one-shot rows (``max_len``
    None, T = min(W, S)) and the dense plane's ring alike.  ``valid_len``
    (an int, dense-plane bucketed prefill) marks the real prompt length
    of right-padded tokens: the logits come from position valid_len - 1
    and "cur" is valid_len, so decode never attends the pad rows and
    overwrites them.  Under capacity routing the MoE layers dispatch the
    whole (B, S) group at once, as in JAX.

    Hybrid: {"k", "v": (n_groups, B, T, K, hd) with T = max_len or S,
    "ssm": (n_layers, B, h, hd, S) f32, "conv": (n_layers, B, w - 1, di)
    bf16, "cur": S}.  Ssm (xLSTM): {"states": {lNN: the layer's final
    mLSTM {"C", "n", "m"} or sLSTM {"c", "n", "h", "m"} state, f32},
    "cur": S}; ``max_len`` does not apply (the state is O(1) a slot).

    Vlm: ``vis_embeds`` (B, P, D) replace the first P token rows (image
    rows), and ``pos_ids`` (B, S, 3) int (t, h, w) rotate q and k with
    M-RoPE; without ``pos_ids`` the attention takes RoPE at [0, S), as in
    JAX.  Other families ignore both, as JAX does.
    """
    require_ported_family(cfg)
    if valid_len is not None and (cfg.family not in _PAGED_FAMILIES
                                  or cfg.sliding_window
                                  or (cfg.family == "moe"
                                      and cfg.moe_routing != "dropless")):
        # right-padding is exact only for causal full attention with
        # pad-invariant routing: not for recurrent state, the ring
        # packing, or capacity-factor MoE (pads consume expert capacity)
        raise ValueError(
            f"bucketed prefill (valid_len) requires a causal-KV family "
            f"without a sliding window and pad-invariant routing, got "
            f"family={cfg.family!r} window={cfg.sliding_window}")
    B, S = tokens.shape
    vlm = cfg.family == "vlm"
    x = _embed(params, tokens, vis_embeds if vlm else None)
    pos3 = pos_ids if vlm else None
    n = S if valid_len is None else int(valid_len)
    cur = torch.full((), n, dtype=torch.int32, device=tokens.device)
    if cfg.family == "ssm":
        x, states = _ssm_forward(params, cfg, x)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return _logits(params, cfg, x[:, -1:])[:, 0], {"states": states,
                                                       "cur": cur}
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
        x, (k, v) = _attn_block(bp, x, cfg, pos3)
        x = _ffn_block(bp, x, cfg)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    last = min(max(n - 1, 0), S - 1)
    logits = _logits(params, cfg, x[:, last:last + 1])[:, 0]
    T = kv_cache_len(cfg, max_len or S)
    k, v = _pack_kv(ks, B, T, cfg, x), _pack_kv(vs, B, T, cfg, x)
    cache = {"k": k, "v": v, "cur": cur}
    if cfg.sliding_window:
        cache["k"], cache["v"], cache["pos"] = _ring_pack(k, v, S, T)
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
    # M-RoPE: every section at the absolute position (text), as in JAX
    pos3 = positions[..., None].expand(B, C, 3) if cfg.m_rope_sections \
        else None
    kp, vp = pages["kp"], pages["vp"]
    kns, vns = [], []
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        attn_out, (kn, vn) = paged_prefill_attn_apply(
            bp["attn"], h, cfg, kp[i], vp[i], block_tables, ctx_lens, pos3)
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
    # M-RoPE: every section at the slot's length (text), as in JAX
    pos3 = seq_lens.long()[:, None, None].expand(B, 1, 3) \
        if cfg.m_rope_sections else None
    kp, vp = pages["kp"], pages["vp"]
    kns, vns = [], []
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        attn_out, (kn, vn) = paged_attn_apply(
            bp["attn"], h, cfg, kp[i], vp[i], block_tables, seq_lens, pos3)
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
# Dense-cache plane
# --------------------------------------------------------------------------
def lm_init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero-initialised dense decode cache, "cur" 0 as a 0-d int32.

    Dense, moe and vlm: {"k", "v": (L, batch, T, K, hd)} in
    ``cfg.cache_dtype`` with T = ``kv_cache_len(cfg, max_len)``, and under
    a sliding window "pos": (T,) int32 all -1 (no ring row written yet).
    Hybrid: {"k", "v": (n_groups, batch, max_len, K, hd) and "conv":
    (n_layers, batch, w - 1, di) in ``cfg.cache_dtype``, "ssm": (n_layers,
    batch, h, hd, S) f32}.  Ssm: {"states": {lNN: the layer's zero mLSTM
    or sLSTM state, f32}}, whatever ``max_len``."""
    require_ported_family(cfg)
    if dtype is None:
        dtype = getattr(torch, cfg.cache_dtype)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    cur = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        states = {}
        for i in range(cfg.n_layers):
            init = xl.slstm_init_state if _layer_kind(cfg, i) == "slstm" \
                else xl.mlstm_init_state
            states[f"l{i:02d}"] = init(cfg, batch, device)
        return {"states": states, "cur": cur}
    if cfg.family != "hybrid":
        T = kv_cache_len(cfg, max_len)
        kv = (cfg.n_layers, batch, T, K, hd)
        c = {"k": torch.zeros(kv, dtype=dtype, device=device),
             "v": torch.zeros(kv, dtype=dtype, device=device), "cur": cur}
        if cfg.sliding_window:
            c["pos"] = torch.full((T,), -1, dtype=torch.int32, device=device)
        return c
    ng, _, _ = hybrid_layout(cfg)
    h, hs, S = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    L = cfg.n_layers
    kv = (ng, batch, max_len, K, hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "ssm": torch.zeros((L, batch, h, hs, S), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((L, batch, cfg.conv_width - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "cur": cur}


def _ssm_decode_step(params, cfg, cache, tokens):
    """The xLSTM decode step (JAX's ``lm_decode_step`` ssm branch): each
    layer's recurrent step from its state; returns new state tensors."""
    x = _embed(params, tokens)
    new_states = {}
    for i in range(cfg.n_layers):
        key = f"l{i:02d}"
        lp = params["layers"][key]
        h = rmsnorm(x, lp["norm"], cfg.norm_eps)
        step = xl.slstm_decode_step if _layer_kind(cfg, i) == "slstm" \
            else xl.mlstm_decode_step
        y, new_states[key] = step(lp, h, cache["states"][key], cfg)
        x = x + y
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], {"states": new_states,
                                           "cur": cache["cur"] + 1}


def _kv_decode_step(params, cfg, cache, tokens):
    """The dense, moe and vlm families' dense-cache decode step (JAX's
    ``lm_decode_step`` dense branch): every slot decodes at ``cur``.
    Without a ring the new k/v land in row ``cur`` (clamped to T - 1) and
    each slot attends rows <= cur; under a sliding window they land in
    ring row ``cur % T``, ``pos`` records cur there, and each slot attends
    the rows with pos >= 0 inside the window.  Attention is plain PyTorch
    (JAX computes it outside any Pallas kernel); the norms and, for moe,
    the expert FFN run in ``kernels.ops`` on a card."""
    cur = cache["cur"]
    T = cache["k"].shape[2]
    x = _embed(params, tokens)
    pos = cache.get("pos") if cfg.sliding_window else None
    if pos is not None:
        write_idx = cur % T
        pos.index_copy_(0, write_idx.long().view(1), cur.view(1))
        k_pos, k_valid = pos, pos >= 0
    else:
        write_idx = cur
        k_pos = torch.arange(T, device=x.device)
        k_valid = k_pos <= cur.long()
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        x = x + dense_decode_attn_apply(bp["attn"], h, cfg, cache["k"][i],
                                        cache["v"][i], cur, write_idx,
                                        k_pos, k_valid)
        x = _ffn_block(bp, x, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    out = {"k": cache["k"], "v": cache["v"], "cur": cur + 1}
    if pos is not None:
        out["pos"] = pos
    return _logits(params, cfg, x)[:, 0], out


def lm_decode_step(params, cfg, cache, tokens):
    """tokens: (B, 1) int32 -> (logits (B, V), cache).  Every slot decodes
    at the shared write index ``cur``; the cache is updated IN PLACE and
    returned with ``cur + 1``.

    Dense, moe and vlm: ``_kv_decode_step``.  Ssm: ``_ssm_decode_step``
    (new state tensors; the engine keeps what it returns).  Hybrid: each
    group's k/v at ``cur`` and each layer's ssm state in place.  The conv leaf comes back
    bf16, as JAX's does: a bf16 leaf is written in place, a leaf of
    another dtype (an f32 cache before its first step) is replaced by a
    bf16 one.
    """
    require_ported_family(cfg)
    if cfg.family == "ssm":
        return _ssm_decode_step(params, cfg, cache, tokens)
    if cfg.family != "hybrid":
        return _kv_decode_step(params, cfg, cache, tokens)
    ng, every, tail = hybrid_layout(cfg)
    cur = cache["cur"]
    x = _embed(params, tokens)
    k_pos = torch.arange(cache["k"].shape[2], device=x.device)
    k_valid = k_pos <= cur.long()
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
                                        cache["k"][g], cache["v"][g], cur,
                                        cur, k_pos, k_valid)
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
