"""xLSTM blocks (PyTorch counterpart of ``repro/models/xlstm.py``):
chunkwise-parallel mLSTM and recurrent sLSTM.

mLSTM is a matrix-memory linear-attention cell with exponential input
gates and sigmoid forget gates, in the *exactly stabilised* chunkwise
form: within a chunk of ``MCHUNK`` positions the pairwise weights carry a
running ``cummax`` stabiliser; across chunks the matrix state is carried
re-scaled by ``exp(-m)``.  Decode is the O(1) recurrent step.  sLSTM is
sequential by nature (as the paper says): JAX's ``lax.scan`` over time is
a Python loop over positions here.

Every product after the projections runs in f32; the output is cast back
to the input dtype only before ``wo``.  The recurrences are plain PyTorch
on a card too: JAX computes them in ``jnp``, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef

MCHUNK = 128


# --------------------------------------------------------------------------
# Schemas
# --------------------------------------------------------------------------
def mlstm_schema(cfg) -> Dict[str, ParamDef]:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    Q = H * hd
    return {
        "wq": ParamDef((D, Q)),
        "wk": ParamDef((D, Q)),
        "wv": ParamDef((D, Q)),
        "wi": ParamDef((D, H), scale=0.02),
        "wf": ParamDef((D, H), scale=0.02),
        "bf": ParamDef((H,), "ones"),    # bias > 0: remember by default
        "wo": ParamDef((Q, D)),
        "ogate": ParamDef((D, Q), scale=0.02),
    }


def slstm_schema(cfg) -> Dict[str, ParamDef]:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    Q = H * hd
    return {
        "wz": ParamDef((D, Q)),
        "wi": ParamDef((D, Q), scale=0.02),
        "wf": ParamDef((D, Q), scale=0.02),
        "wog": ParamDef((D, Q), scale=0.02),
        "rz": ParamDef((H, hd, hd), scale=0.02),
        "ri": ParamDef((H, hd, hd), scale=0.02),
        "rf": ParamDef((H, hd, hd), scale=0.02),
        "ro": ParamDef((H, hd, hd), scale=0.02),
        "bf": ParamDef((Q,), "ones"),
        "wo": ParamDef((Q, D)),
    }


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def _mlstm_qkv(p, x, cfg):
    """Projections of x (B, L, D): q, v (B, L, H, hd) in x.dtype, k in
    f32 (JAX divides the projection by a numpy f64 scalar, which promotes
    it), the log input and log forget gates (B, L, H) and the output gate
    (B, L, H, hd) in f32."""
    B, L, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, L, H, hd)
    k = (x @ p["wk"]).reshape(B, L, H, hd).float() / float(np.sqrt(hd))
    v = (x @ p["wv"]).reshape(B, L, H, hd)
    li = (x @ p["wi"]).float()                              # log input gate
    lf = F.logsigmoid((x @ p["wf"]).float() + p["bf"].float())  # log forget
    og = torch.sigmoid((x @ p["ogate"]).float()).reshape(B, L, H, hd)
    return q, k, v, li, lf, og


def mlstm_init_state(cfg, batch: int, device=None):
    H, hd = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), -1e30, **f32)}


def _mlstm_chunk(carry, qq, kk, vv, lii, lff):
    """One chunk of the stabilised form.  carry (C, n, m) is scaled by
    exp(-m); qq/kk/vv (B, Cn, H, hd), lii/lff (B, Cn, H), all f32.
    Returns (carry at the chunk's end, y (B, Cn, H, hd))."""
    Cmat, nvec, m_in = carry
    Cn = qq.shape[1]
    LF = torch.cumsum(lff, dim=1)                 # (B, Cn, H) inclusive
    a = lii - LF
    mloc = torch.cummax(a, dim=1).values
    mt = torch.maximum(m_in[:, None, :], mloc)

    # intra-chunk pairwise weights (the mask goes in before exp)
    w_log = a[:, None, :, :] - mt[:, :, None, :]          # (B, t, s, H)
    tri = torch.ones((Cn, Cn), dtype=torch.bool, device=qq.device).tril()
    w = torch.exp(w_log.masked_fill(~tri[None, :, :, None], float("-inf")))
    qk = torch.einsum("bthd,bshd->btsh", qq, kk)
    y_intra = torch.einsum("btsh,bshd->bthd", qk * w, vv)
    n_intra = torch.einsum("btsh,bshd->bthd", w, kk)

    # the incoming state's contribution
    w_in = torch.exp(m_in[:, None, :] - mt)               # (B, Cn, H)
    y_in = torch.einsum("bthd,bhde->bthe", qq, Cmat) * w_in[..., None]
    n_in = torch.einsum("bthd,bhd->bth", qq, nvec) * w_in
    n_dot = torch.einsum("bthd,bthd->bth", qq, n_intra) + n_in
    denom = torch.clamp(n_dot.abs(), min=1.0)[..., None]
    yt = (y_intra + y_in) / denom

    # the carry, rescaled to m_out
    F_tot = LF[:, -1, :]                                   # (B, H)
    m_out = F_tot + torch.maximum(m_in, mloc[:, -1, :])
    s_in = torch.exp(m_in + F_tot - m_out)                 # <= 1
    wS = torch.exp(a + F_tot[:, None, :] - m_out[:, None, :])
    C_new = Cmat * s_in[:, :, None, None] + \
        torch.einsum("bsh,bshd,bshe->bhde", wS, kk, vv)
    n_new = nvec * s_in[:, :, None] + torch.einsum("bsh,bshd->bhd", wS, kk)
    return (C_new, n_new, m_out), yt


def mlstm_apply(p, x, cfg, state=None) -> Tuple[torch.Tensor, dict]:
    """Chunkwise-parallel mLSTM.  x: (B, L, D) -> ((B, L, D), final state
    {"C", "n", "m"}).  L pads up to a multiple of ``MCHUNK`` as in JAX:
    q/k/v with zeros, the log input gate with -1e30 and the log forget
    gate with 0, so the pad rows leave the final state as it was."""
    B, L, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v, li, lf, og = _mlstm_qkv(p, x, cfg)
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    Cn = MCHUNK
    Lp = -(-L // Cn) * Cn
    q, k, v = q.float(), k.float(), v.float()
    if Lp != L:
        pad = Lp - L
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad))
    carry = (state["C"], state["n"], state["m"])
    ys = []
    for c in range(Lp // Cn):
        sl = slice(c * Cn, (c + 1) * Cn)
        carry, y_c = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                  li[:, sl], lf[:, sl])
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :L]
    y = (y * og).reshape(B, L, H * hd).to(x.dtype)
    Cf, nf, mf = carry
    return y @ p["wo"], {"C": Cf, "n": nf, "m": mf}


def mlstm_decode_step(p, x, state, cfg) -> Tuple[torch.Tensor, dict]:
    """The exact recurrent step.  x: (B, 1, D) -> ((B, 1, D), state)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v, li, lf, og = _mlstm_qkv(p, x, cfg)
    q, k, v = (t.float()[:, 0] for t in (q, k, v))           # (B, H, hd)
    li, lf = li[:, 0], lf[:, 0]                               # (B, H)
    m_new = torch.maximum(lf + state["m"], li)
    fw = torch.exp(lf + state["m"] - m_new)
    iw = torch.exp(li - m_new)
    C = state["C"] * fw[:, :, None, None] + \
        iw[:, :, None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = state["n"] * fw[:, :, None] + iw[:, :, None] * k
    n_dot = torch.einsum("bhd,bhd->bh", q, n)
    denom = torch.clamp(n_dot.abs(), min=1.0)[..., None]
    y = torch.einsum("bhd,bhde->bhe", q, C) / denom
    y = (y * og[:, 0]).reshape(B, 1, H * hd).to(x.dtype)
    return y @ p["wo"], {"C": C, "n": n, "m": m_new}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def slstm_init_state(cfg, batch: int, device=None):
    """Four distinct (B, H, hd) f32 leaves: the engine splices into each
    in place, so none may share storage with another."""
    H, hd = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "h": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H, hd), -1e30, **f32)}


_RECURRENT = ("rz", "ri", "rf", "ro")


def _slstm_step(p, cfg, state, gates):
    """gates: the input projections (B, H, hd, 4) z, i, f, o in f32."""
    h = state["h"]                                          # (B, H, hd)
    rz, ri, rf, ro = (torch.einsum("bhd,hde->bhe", h, p[n].float())
                      for n in _RECURRENT)
    zt = torch.tanh(gates[..., 0] + rz)
    it = gates[..., 1] + ri                                 # log-space
    ft = gates[..., 2] + rf
    ot = torch.sigmoid(gates[..., 3] + ro)
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + state["m"], it)
    fw = torch.exp(lf + state["m"] - m_new)
    iw = torch.exp(it - m_new)
    c = fw * state["c"] + iw * zt
    n = fw * state["n"] + iw
    hnew = ot * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": hnew, "m": m_new}, hnew


def _slstm_gates(p, x, cfg):
    """(B, L, D) -> (B, L, H, hd, 4) f32 gates, the gate index LAST, as
    JAX's ``stack(..., -1)``; the forget bias adds in the param dtype."""
    B, L, _ = x.shape
    g = torch.stack([x @ p["wz"], x @ p["wi"], x @ p["wf"] + p["bf"],
                     x @ p["wog"]], dim=-1).float()
    return g.reshape(B, L, cfg.n_heads, cfg.head_dim, 4)


def slstm_apply(p, x, cfg, state=None) -> Tuple[torch.Tensor, dict]:
    """The sequential sLSTM over x (B, L, D), one position at a time."""
    B, L, _ = x.shape
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    g = _slstm_gates(p, x, cfg)
    r = {n: p[n].float() for n in _RECURRENT}   # widened once, not a step
    hs = []
    for t in range(L):
        state, h = _slstm_step(r, cfg, state, g[:, t])
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, L, -1).to(x.dtype)
    return y @ p["wo"], state


def slstm_decode_step(p, x, state, cfg) -> Tuple[torch.Tensor, dict]:
    B = x.shape[0]
    state, h = _slstm_step(p, cfg, state, _slstm_gates(p, x, cfg)[:, 0])
    return h.reshape(B, 1, -1).to(x.dtype) @ p["wo"], state
