"""Top-k MoE with group-local sort-based dispatch (PyTorch counterpart of
``repro/models/moe.py``).

Line for line with the JAX module, without its sharding constraints (the
port runs on one card, so the mesh-derived group count is 1 unless
``n_groups`` is given).  Router, softmax, top-k, the stable argsort, the
per-expert counts, the dispatch table, the gather and the gate rows are
plain torch.  Two places go through the hand-written kernels of
``kernels.ops``:

* the three expert projections (JAX's einsum fallback of
  ``kernels.moe_gmm``) are ``ops.moe_gmm`` on the ``(G*E, C, .)`` slabs,
  the G dispatch groups folded into the expert dimension;
* the gated combine (JAX's ``zeros((Tl+1, D)).at[tok].add(contrib)``)
  is ``ops.rao_scatter_add`` into one zero table of ``G * (Tl+1)`` rows,
  each group's rows offset by ``g * (Tl+1)`` — the paper's RAO SCATTER
  pattern, with every dispatch padding row landing on its group's pad
  row ``Tl``.

``cfg.moe_routing == "dropless"`` sets the per-group capacity C = Tl, so
no assignment can drop and the layer is a pure per-token function (the
serving plane's mode); ``"capacity"`` keeps the training-parity
capacity-factor drops.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamDef


def moe_schema(cfg) -> Dict[str, ParamDef]:
    """Router and stacked expert weights.  The JAX schema's two layouts
    (``cfg.infer_weight_layout``) differ only in their sharding axes, so
    the shapes here serve both."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {
        "router": ParamDef((D, E), scale=0.02),
        "wg": ParamDef((E, D, Fe)),
        "wu": ParamDef((E, D, Fe)),
        "wd": ParamDef((E, Fe, D)),
    }


def _capacity(cfg, n_tokens: int) -> int:
    """Per-group per-expert capacity.

    ``dropless``: C = Tl — top_k indices are distinct per token, so at
    most Tl of a group's assignments can land on any one expert and
    rank-in-expert tops out at Tl - 1 < C.

    ``capacity``: C = ceil(k*Tl/E * cf) with a top_k floor, clamped to
    Tl last (no more than Tl tokens can rank into one expert).
    """
    if cfg.moe_routing == "dropless":
        return n_tokens
    c = int(np.ceil(cfg.top_k * n_tokens / cfg.n_experts *
                    cfg.capacity_factor))
    return min(max(cfg.top_k, c), n_tokens)


def _n_groups(cfg, T: int) -> int:
    """Dispatch groups: the JAX module derives them from the mesh's
    ``pod x data`` axes; the port has no mesh, so one group."""
    return 1


def moe_apply(p, x, cfg, return_aux: bool = False, n_groups: int = 0):
    """x: (B, S, D) -> (B, S, D) [, aux losses dict].

    ``n_groups`` overrides the group count (tests; must divide B*S).
    """
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    G = n_groups or _n_groups(cfg, T)
    assert T % G == 0, (T, G)
    Tl = T // G
    C = _capacity(cfg, Tl)
    dev = x.device

    xf = x.reshape(G, Tl, D)
    logits = torch.einsum("gtd,de->gte", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                      # (G,Tl,E) f32
    # lax.top_k order: descending, ties to the lower expert index
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top.values[..., :K], top.indices[..., :K]    # (G,Tl,K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- group-local sorted dispatch ----
    flat_e = eidx.reshape(G, Tl * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)         # (G,TlK)
    sorted_e = torch.gather(flat_e, -1, order)

    counts = torch.zeros((G, E), dtype=torch.int64, device=dev) \
        .scatter_add_(-1, flat_e, torch.ones_like(flat_e))     # (G,E)
    offsets = torch.cumsum(counts, dim=-1) - counts            # (G,E)
    off_sorted = torch.gather(offsets, -1, sorted_e)
    slot = torch.arange(Tl * K, device=dev)[None] - off_sorted  # rank in expert
    keep = slot < C
    src_tok = order // K                                       # (G,TlK)
    dest = sorted_e * C + slot                                 # (G,TlK)
    # kept assignments land at their dest; dropped ones on a dump column
    # E*C that is cut off (JAX: mode="drop")
    at = torch.where(keep, dest, torch.full_like(dest, E * C))

    table = torch.full((G, E * C + 1), Tl, dtype=torch.int32, device=dev) \
        .scatter_(-1, at, src_tok.to(torch.int32))[:, :E * C]  # (G,E*C)

    x_pad = torch.cat([xf, xf.new_zeros((G, 1, D))], dim=1)
    xe = torch.gather(x_pad, 1, table.long()[:, :, None].expand(G, E * C, D))

    # ---- grouped FFN: the moe_gmm kernel, groups folded into experts ----
    xe = xe.reshape(G * E, C, D)

    def experts(w):
        return w.repeat(G, 1, 1) if G > 1 else w
    g_ = kops.moe_gmm(xe, experts(p["wg"]))
    u_ = kops.moe_gmm(xe, experts(p["wu"]))
    h = F.silu(g_.float()).to(x.dtype) * u_
    ye = kops.moe_gmm(h, experts(p["wd"])).reshape(G, E * C, D)

    # ---- combine: scatter-add with gates (the rao_scatter_add kernel) ----
    gate_flat = torch.gather(gates.reshape(G, Tl * K), -1, order)
    gate_rows = torch.zeros((G, E * C + 1), dtype=torch.float32,
                            device=dev).scatter_(-1, at, gate_flat)[:, :E * C]
    contrib = ye * gate_rows[:, :, None].to(ye.dtype)
    rows = table + (torch.arange(G, device=dev, dtype=torch.int32)[:, None]
                    * (Tl + 1))
    y = kops.rao_scatter_add(
        torch.zeros((G * (Tl + 1), D), dtype=ye.dtype, device=dev),
        rows.reshape(-1), contrib.reshape(G * E * C, D))
    y = y.reshape(G, Tl + 1, D)[:, :Tl]                        # (G,Tl,D)

    out = y.reshape(B, S, D)
    if not return_aux:
        return out
    me = probs.mean((0, 1))                                    # (E,)
    ce = (counts.sum(0) / max(1, T * K)).float()
    aux = {"load_balance": E * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2)}
    return out, aux
