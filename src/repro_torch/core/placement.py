"""Cohet placement planner: where do a job's tensors live?

Adapts the paper's unified-pool idea to the training/serving framework: given
the dry-run memory analysis of a (arch x shape x mesh) cell and a per-chip
HBM budget, plan which state trees (params / optimizer moments / KV cache)
stay in HBM vs spill to the coherent host/CXL tiers, and estimate the
per-step overhead with the SimCXL-calibrated bandwidth/latency constants.

The decision rule encodes the paper's central measurement: fine-grained
(sub-8KB) irregular traffic wants the coherent (CXL.cache-like) path, bulk
sequential traffic wants DMA streaming (Figs 13-16 crossover).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.simcxl.params import FPGA_400MHZ, SimCXLParams

# A TPU's HBM (16 GiB at 819 GB/s): the defaults for a CPU run only.  On a
# CUDA device the serving engine passes the card's own capacity
# (``torch.cuda.get_device_properties(dev).total_memory``) as
# ``hbm_budget`` instead (runtime.server._device_hbm_bytes).
HBM_BYTES = 16 << 30
HBM_BW = 819e9


@dataclass
class TensorClass:
    name: str
    bytes_per_device: int
    access: str           # 'every_step_bulk' | 'sparse_fine' | 'rare_bulk'
    priority: int         # lower = keep in HBM first
    # coherent consumers reading ONE physical copy (prefix-shared KV pages):
    # bytes_per_device is counted once, and the sparse_fine offload cost is
    # amortized across sharers — a DMA design would replicate per consumer
    sharers: int = 1


@dataclass
class PlacementPlan:
    assignments: Dict[str, str]
    hbm_used: int
    spilled: int
    est_step_overhead_s: float
    notes: List[str]


def _offload_cost_s(tc: TensorClass, p: SimCXLParams) -> float:
    """Per-step cost of serving this tensor class from the host/CXL tier."""
    if tc.access == "every_step_bulk":
        # streamed in+out once per step over the DMA path
        return 2 * tc.bytes_per_device / (p.dma_stream_bw_GBs * 1e9)
    if tc.access == "sparse_fine":
        # fine-grained coherent loads: latency-bound estimate at line size;
        # shared regions serve all coherent readers from one copy, so the
        # per-consumer cost divides by the sharer count
        lines = tc.bytes_per_device / p.line_bytes
        return (lines * p.mem_issue_ns * 1e-9 * 0.01   # ~1% touched per step
                / max(1, tc.sharers))
    return 0.0  # rare_bulk (checkpoint-grade) is off the step path


def classify_train_state(mem: Dict[str, int]) -> List[TensorClass]:
    """From dry-run memory numbers: params/opt/activations per device."""
    args = mem.get("argument_size_in_bytes", 0)
    temp = mem.get("temp_size_in_bytes", 0)
    # args ~= params (bf16) + moments (f32x2): split 1:4 by dtype ratio
    params = args // 5
    moments = args - params
    return [
        TensorClass("activations+workspace", temp, "every_step_bulk", 0),
        TensorClass("params", params, "every_step_bulk", 1),
        TensorClass("opt_moments", moments, "every_step_bulk", 2),
    ]


def classify_decode_state(mem: Dict[str, int]) -> List[TensorClass]:
    args = mem.get("argument_size_in_bytes", 0)
    temp = mem.get("temp_size_in_bytes", 0)
    params = min(args, temp) // 2
    kv = args - params
    return [
        TensorClass("workspace", temp, "every_step_bulk", 0),
        TensorClass("params", params, "every_step_bulk", 1),
        TensorClass("kv_cache", kv, "sparse_fine", 2),
    ]


def plan_placement(classes: List[TensorClass], *,
                   hbm_budget: int = HBM_BYTES,
                   params: SimCXLParams = FPGA_400MHZ) -> PlacementPlan:
    """Greedy: keep lowest-priority-value classes in HBM; spill the rest to
    the coherent pool, scoring the step-time overhead."""
    assignments: Dict[str, str] = {}
    notes: List[str] = []
    used = 0
    spilled = 0
    overhead = 0.0
    for tc in sorted(classes, key=lambda t: t.priority):
        if used + tc.bytes_per_device <= hbm_budget:
            assignments[tc.name] = "hbm"
            used += tc.bytes_per_device
        else:
            tier = "host" if tc.access != "rare_bulk" else "cxl"
            assignments[tc.name] = tier
            spilled += tc.bytes_per_device
            cost = _offload_cost_s(tc, params)
            overhead += cost
            notes.append(
                f"{tc.name}: spilled {tc.bytes_per_device/2**30:.2f} GiB to "
                f"{tier} (+{cost*1e3:.2f} ms/step, {tc.access})")
    if not notes:
        notes.append("everything fits in HBM; no offload needed")
    return PlacementPlan(assignments, used, spilled, overhead, notes)


def plan_for_dryrun_record(rec: dict, *, hbm_budget: int = HBM_BYTES) -> PlacementPlan:
    mem = rec.get("memory", {})
    if rec.get("kind") == "train":
        classes = classify_train_state(mem)
    else:
        classes = classify_decode_state(mem)
    return plan_placement(classes, hbm_budget=hbm_budget)
