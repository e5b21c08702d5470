"""Mamba2-style selective state-space block (PyTorch counterpart of
``repro/models/ssm.py``): SSD chunkwise prefill and the O(1) recurrent
decode step.

The chunked scan that JAX's ``mamba_apply`` computes inline goes through
``kernels.ops.ssd_scan``: the hand-written ``ssd_scan`` kernel on a card,
its plain version (the same chunk math) on the CPU.  The kernel also
returns the final state that prefill hands to decode.  The gated norm
runs on the ``rmsnorm`` kernel through ``layers.rmsnorm``; the decode
step is plain PyTorch, as JAX's is jnp.  The conv tail is returned in
bf16 whatever the compute dtype, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamDef, rmsnorm

CHUNK = 128


def mamba_schema(cfg) -> Dict[str, ParamDef]:
    D, di, S, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    w = cfg.conv_width
    return {
        "wz": ParamDef((D, di)),
        "wx": ParamDef((D, di)),
        "wB": ParamDef((D, S)),
        "wC": ParamDef((D, S)),
        "wdt": ParamDef((D, h)),
        "conv": ParamDef((w, di), scale=0.5),
        "A_log": ParamDef((h,), "zeros"),
        "D_skip": ParamDef((h,), "ones"),
        "dt_bias": ParamDef((h,), "zeros"),
        "gnorm": ParamDef((di,), "zeros"),
        "wo": ParamDef((di, D)),
    }


def _proj(p, x):
    """x: (B, L, D) -> z, xin (B, L, di); B, C (B, L, S) f32; dt (B, L, h)
    f32 after softplus."""
    z = x @ p["wz"]
    xin = x @ p["wx"]
    Bm = (x @ p["wB"]).float()
    Cm = (x @ p["wC"]).float()
    dt = (x @ p["wdt"]).float()
    dt = F.softplus(dt + p["dt_bias"].float())
    return z, xin, Bm, Cm, dt


def _gate_out(p, y, z, cfg, dtype):
    """Gated RMSNorm, then the out-projection."""
    y = rmsnorm(y * F.silu(z.float()).to(dtype), p["gnorm"], cfg.norm_eps)
    return y @ p["wo"]


def mamba_apply(p, x, cfg, return_state: bool = False):
    """Chunkwise SSD forward.  x: (B, L, D) -> (B, L, D); any L.  With
    ``return_state``, also the decode state {"ssm": (B, h, hd, S) f32,
    "conv": (B, w - 1, di) bf16}."""
    B, L, D = x.shape
    h, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
    di = cfg.d_inner
    z, xin_raw, Bm, Cm, dt = _proj(p, x)

    # causal depthwise conv on xin
    w = cfg.conv_width
    pad = torch.zeros((B, w - 1, di), dtype=xin_raw.dtype, device=x.device)
    xc = torch.cat([pad, xin_raw], dim=1)
    kern = p["conv"].float()                                    # (w, di)
    xin = sum(xc[:, i:i + L].float() * kern[i] for i in range(w))
    xin = F.silu(xin).to(x.dtype)

    A = -torch.exp(p["A_log"].float())                          # (h,)
    xh = xin.reshape(B, L, h, hd)
    y, st_f = kops.ssd_scan(xh, Bm.contiguous(), Cm.contiguous(),
                            dt.contiguous(), A, chunk=CHUNK)
    y = y + p["D_skip"].float()[None, None, :, None] * xh.float()
    out = _gate_out(p, y.reshape(B, L, di).to(x.dtype), z, cfg, x.dtype)
    if not return_state:
        return out
    conv_tail = xc[:, L:]                                # last w-1 raw xin
    return out, {"ssm": st_f, "conv": conv_tail.to(torch.bfloat16)}


def mamba_init_state(cfg, batch: int, device=None):
    h, hd, S = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, h, hd, S), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                            dtype=torch.bfloat16, device=device),
    }


def mamba_decode_step(p, x, state, cfg) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent step.  x: (B, 1, D); state as
    ``mamba_init_state``.  Returns (out (B, 1, D), new state)."""
    B = x.shape[0]
    h, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
    di = cfg.d_inner
    z, xin, Bm, Cm, dt = _proj(p, x)

    # conv ring: state["conv"]: (B, w-1, di)
    xc = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)  # (B, w, di)
    kern = p["conv"].float()
    xconv = torch.einsum("bwd,wd->bd", xc.float(), kern)[:, None]
    xconv = F.silu(xconv).to(x.dtype)                           # (B, 1, di)
    new_conv = xc[:, 1:]

    A = -torch.exp(p["A_log"].float())
    xh = xconv.reshape(B, h, hd).float()                        # (B, h, hd)
    dt0 = dt[:, 0]                                              # (B, h)
    dec = torch.exp(dt0 * A)
    st = state["ssm"] * dec[:, :, None, None] + \
        torch.einsum("bh,bhd,bs->bhds", dt0, xh, Bm[:, 0])
    y = torch.einsum("bs,bhds->bhd", Cm[:, 0], st)
    y = y + p["D_skip"].float()[None, :, None] * xh
    out = _gate_out(p, y.reshape(B, 1, di).to(x.dtype), z, cfg, x.dtype)
    return out, {"ssm": st, "conv": new_conv.to(torch.bfloat16)}
