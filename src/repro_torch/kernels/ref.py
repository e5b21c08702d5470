"""Plain PyTorch versions of the paged attention kernels.

Line for line with the jnp oracles of ``repro/kernels/ref.py``: dense
gather of the block-table pages, f32 scores and softmax, output in
``q.dtype``.  The CPU path of ``kernels.ops`` and the kernel-vs-plain
comparison in ``chip_smoke.py`` use these; the serving path on a card
never does.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    k_new, v_new, *, window: int = 0,
                    scale: float | None = None):
    """Single-query-per-slot decode attention over a block-table-indexed
    KV pool.

    q: (B, H, hd), H % K == 0 (GQA); k_pages, v_pages: (P, bt, K, hd);
    block_tables: (B, nb) int — entries < 0 are clamped to page 0 and NOT
    masked inside the live range (the decode contract); seq_lens: (B,)
    tokens resident — the query at position ``seq_lens`` attends to
    p < seq_lens (and, with a window, p > seq_lens - window) plus the
    not-yet-paged current token (k_new, v_new): (B, K, hd).
    Returns (B, H, hd) in q.dtype.
    """
    B, H, hd = q.shape
    P, bt, K, _ = k_pages.shape
    nb = block_tables.shape[1]
    G = H // K
    scale = scale or 1.0 / math.sqrt(hd)

    pages = block_tables.long().clamp_min(0)             # (B, nb)
    kg = k_pages[pages].reshape(B, nb * bt, K, hd)       # gather, pos order
    vg = v_pages[pages].reshape(B, nb * bt, K, hd)
    pos = torch.arange(nb * bt, device=q.device)[None, :]     # (1, T)
    lens = seq_lens.long()[:, None]
    live = pos < lens
    if window:
        live &= pos > (lens - window)

    qg = q.reshape(B, K, G, hd).float()
    s_old = torch.einsum("bkgd,btkd->bkgt", qg, kg.float()) * scale
    s_old = s_old.masked_fill(~live[:, None, None, :], NEG_INF)
    s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new.float()) * scale
    s = torch.cat([s_old, s_new[..., None]], dim=-1)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w[..., :-1], vg.float())
    out = out + w[..., -1:] * v_new[:, :, None, :].float()
    return out.reshape(B, H, hd).to(q.dtype)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                            k_new, v_new, *, window: int = 0,
                            scale: float | None = None):
    """Chunked-prefill attention over a partial paged context.

    q: (B, C, H, hd); k_pages, v_pages: (P, bt, K, hd); block_tables:
    (B, nb) int — entries < 0 are masked dead (the prefill contract);
    ctx_lens: (B,) tokens resident — chunk query c sits at absolute
    position ``ctx_lens + c`` and attends to page positions p < ctx_lens
    (with a window: p > ctx_lens + c - window) plus the chunk's own keys
    u <= c (and u > c - window): k_new, v_new (B, C, K, hd).  Every row
    gets finite output (the diagonal is always live).
    Returns (B, C, H, hd) in q.dtype.
    """
    B, C, H, hd = q.shape
    P, bt, K, _ = k_pages.shape
    nb = block_tables.shape[1]
    G = H // K
    scale = scale or 1.0 / math.sqrt(hd)
    dev = q.device

    pages = block_tables.long().clamp_min(0)             # (B, nb)
    kg = k_pages[pages].reshape(B, nb * bt, K, hd)       # gather, pos order
    vg = v_pages[pages].reshape(B, nb * bt, K, hd)
    pos = torch.arange(nb * bt, device=dev)[None, None, :]    # (1, 1, T)
    ctx = ctx_lens.long()
    qpos = (ctx[:, None]
            + torch.arange(C, device=dev)[None, :])[:, :, None]  # (B, C, 1)
    live = (pos < ctx[:, None, None]) \
        & (block_tables >= 0).repeat_interleave(bt, dim=1)[:, None, :]
    if window:
        live = live & (pos > qpos - window)
    live = live.expand(B, C, nb * bt)

    qg = q.reshape(B, C, K, G, hd).float()
    s_old = torch.einsum("bckgd,btkd->bkgct", qg, kg.float()) * scale
    s_old = s_old.masked_fill(~live[:, None, None, :, :], NEG_INF)
    s_new = torch.einsum("bckgd,bukd->bkgcu", qg, k_new.float()) * scale
    cq = torch.arange(C, device=dev)[:, None]
    cu = torch.arange(C, device=dev)[None, :]
    self_mask = cu <= cq                                  # causal in-chunk
    if window:
        self_mask = self_mask & (cu > cq - window)
    s_new = s_new.masked_fill(~self_mask[None, None, None], NEG_INF)
    s = torch.cat([s_old, s_new], dim=-1)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", w[..., : nb * bt], vg.float())
    out = out + torch.einsum("bkgcu,bukd->bckgd", w[..., nb * bt:],
                             v_new.float())
    return out.reshape(B, C, H, hd).to(q.dtype)
