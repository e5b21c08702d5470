"""Plain PyTorch versions of the hand-written kernels.

Line for line with the jnp oracles of ``repro/kernels/ref.py``: for the
paged attention kernels a dense gather of the block-table pages, f32
scores and softmax, output in ``q.dtype``; for ``flash_attention`` the
same over the prompt's own keys, read per kv head (no repeat to H heads),
the weights rounded to ``v.dtype`` before P.V as JAX's ``gqa_attention``
rounds them;
for ``moe_gmm`` an f32 einsum cast to ``xe.dtype``; for
``rao_scatter_add`` an accumulating index put in f32, cast to the table's
dtype; for ``rmsnorm`` the f32 formula of ``repro/models/layers.py``; for
``ssd_scan`` the chunk math of ``repro/models/ssm.py``'s ``mamba_apply``
(which also yields the final state).  The CPU path of ``kernels.ops`` and
the kernel-vs-plain comparison in ``chip_smoke.py`` use these; the
serving path on a card never does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rmsnorm(x, w, eps: float = 1e-5):
    """x: (..., D), w: (D,) -> x.shape in x.dtype:
    ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, rounded once."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Blocked-softmax attention's function, unblocked.

    q: (B, S, H, hd); k, v: (B, T, K, hd), H % K == 0 (GQA: query head h
    reads kv head h // (H / K)).  Query c and key u sit at absolute
    positions c and u; u is live iff u <= c when ``causal`` and
    u > c - window with a window.  f32 scores and sums, masked scores
    -1e30 with their weight zeroed, denominator clamped at 1e-20.  The
    normalised weights are rounded to v.dtype before P.V, as JAX's
    ``gqa_attention`` rounds them (``w.astype(v.dtype)``): a no-op at f32,
    one bf16 rounding per weight at bf16.  P.V then sums in f32 and is
    rounded once to q.dtype.  Returns (B, S, H, hd) in q.dtype.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale or 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, K, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    live = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        live &= kp <= qp
    if window:
        live &= kp > qp - window
    s = s.masked_fill(~live, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * live
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    w = (p / den).to(v.dtype).float()
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


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


def ssd_scan(x, Bm, Cm, dt, A, *, chunk: int = 128):
    """Chunked Mamba2/SSD scan, the chunk math of ``mamba_apply``
    (``repro/models/ssm.py``).

    x: (B, L, h, hd); Bm, Cm: (B, L, S) f32; dt: (B, L, h) f32; A: (h,)
    f32, negative.  Any L: the last chunk is zero-padded, and a padded
    step (dt = 0) neither decays nor adds.  Per chunk, with ``acs`` the
    inclusive cumsum of dt * A:
    ``y_t = sum_{s<=t} exp(acs_t - acs_s) dt_s (C_t . B_s) x_s
    + exp(acs_t) C_t . st^T`` and
    ``st <- st exp(acs_end) + sum_s exp(acs_end - acs_s) dt_s x_s B_s^T``,
    the upper triangle masked to -inf before the exp.  Returns (y (B, L,
    h, hd) f32, final state (B, h, hd, S) f32).
    """
    Bsz, L, h, hd = x.shape
    S = Bm.shape[-1]
    nC = -(-L // chunk)
    pad = nC * chunk - L
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    Bf = F.pad(Bm.float(), (0, 0, 0, pad))
    Cf = F.pad(Cm.float(), (0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    A = A.float()
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    st = torch.zeros((Bsz, h, hd, S), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nC):
        sl = slice(c * chunk, (c + 1) * chunk)
        xb, Bb, Cb, dtb = xf[:, sl], Bf[:, sl], Cf[:, sl], dtf[:, sl]
        acs = torch.cumsum(dtb * A, dim=1)                      # (B, C, h)
        decay = acs[:, :, None, :] - acs[:, None, :, :]         # (B, t, s, h)
        decay = decay.masked_fill(~tri[None, :, :, None], -math.inf)
        CB = torch.einsum("btn,bsn->bts", Cb, Bb)
        M = CB[..., None] * torch.exp(decay) * dtb[:, None, :, :]
        y = torch.einsum("btsh,bshd->bthd", M, xb)
        y = y + torch.einsum("btn,bhdn,bth->bthd", Cb, st, torch.exp(acs))
        wts = torch.exp(acs[:, -1:, :] - acs) * dtb              # (B, C, h)
        st = st * torch.exp(acs[:, -1, :])[:, :, None, None] + \
            torch.einsum("bsh,bshd,bsn->bhdn", wts, xb, Bb)
        ys.append(y)
    if not ys:
        return xf.new_zeros((Bsz, 0, h, hd)), st
    return torch.cat(ys, dim=1)[:, :L], st


def moe_gmm(xe, w):
    """Grouped expert matmul.  xe: (E, C, D), w: (E, D, F) -> (E, C, F),
    summed in f32 and cast to ``xe.dtype``."""
    return torch.einsum("ecd,edf->ecf", xe.float(), w.float()).to(xe.dtype)


def rao_scatter_add(table, idx, vals):
    """Atomic scatter-accumulate (RAO FAA over rows): a copy of ``table``
    (N, D) with ``vals`` (M, D) added at rows ``idx`` (M,), duplicates
    summed, in ``table.dtype``.  Each row is summed in f32 and rounded to
    ``table.dtype`` once, as ``moe_gmm`` sums in f32: a bf16 sum rounded
    at every add would depend on the order of the adds, which neither
    the TPU kernel nor the CUDA one fixes the same way."""
    acc = table.to(torch.float32, copy=True)
    return acc.index_put_((idx.long(),), vals.float(),
                          accumulate=True).to(table.dtype)
