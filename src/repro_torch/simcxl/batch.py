"""Vectorized batch-sweep engine for SimCXL.

The discrete-event models in ``engine.py``/``lsu.py``/``link.py``/``nic.py``
evaluate one transaction at a time, which is exact but slow: a full
calibration or figure sweep replays tens of thousands of Python-level
events *per parameter point*.  Design-space sweeps (frequency x tier x
pattern x payload) need thousands of points.

This module evaluates the same transaction flows in closed form as one
array program (numpy), exploiting a structural
property of the DES: every modeled pipeline is a *deterministic tandem
queue* — stage k is a FIFO server with fixed occupancy ``occ_k`` and all
requests of a probe arrive back-to-back.  For such queues the DES recursion

    start_i^k = max(start_i^{k-1}, start_{i-1}^k + occ_k),  start_0 = 0

has the exact solution ``start_i = i * max_k occ_k`` (all-at-once arrivals)
and per-request latency equals the unloaded path latency (serialized
arrivals), so medians, means, and PMU-window bandwidths all reduce to
closed forms.  The DES stays the golden reference: ``tests/
test_batch_vs_des.py`` cross-validates every shared flow to a relative
error <= 1e-6.

Supported flows (shared with the DES):

=================  =======================================================
flow               pattern / semantics
=================  =======================================================
``cxl.cache``      LSU load probes; pattern is the tier ``hmc|llc|mem``
                   (``lsu.run_lsu`` equivalence, incl. NUMA node + jitter)
``cxl.io.dma``     DMA engine; latency (Fig 14) and stream bw (Fig 16)
``cxl.io.mmio``    posted write / read doorbell latency
``rao.cxl``        CXL-NIC RAO, deterministic patterns CENTRAL | STRIDE1
``rao.pcie``       PCIe-NIC RAO (any pattern; timing is pattern-blind)
=================  =======================================================

Random-address RAO patterns (SCATTER/GATHER/SG/RAND) and the RPC pipelines
keep their DES/closed-form paths in ``nic.py`` — their hit rates depend on
LRU set-eviction histories that have no closed form.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence

import numpy as np

from repro_torch.simcxl.params import FPGA_400MHZ, SimCXLParams

ELEM = 8  # u64 atomics (see nic.py)

_CACHE_TIERS = ("hmc", "llc", "mem")
_FLOWS = ("cxl.cache", "cxl.io.dma", "cxl.io.mmio", "rao.cxl", "rao.pcie")


@dataclass(frozen=True)
class SweepPoint:
    """One (flow, pattern, size, params) evaluation point of a sweep."""
    flow: str
    pattern: str = "mem"          # tier | "write"/"read" | RAO pattern
    mode: str = "latency"         # "latency" (serialized) | "bandwidth"
    size: int = 64                # payload bytes (DMA); line for cxl.cache
    n_requests: int = 32
    numa_node: int = 7
    jitter: bool = False
    seed: int = 0
    params: SimCXLParams = FPGA_400MHZ

    def validate(self):
        if self.flow not in _FLOWS:
            raise ValueError(f"unknown flow {self.flow!r}; one of {_FLOWS}")
        if self.flow == "cxl.cache" and self.pattern not in _CACHE_TIERS:
            raise ValueError(f"cxl.cache tier must be one of {_CACHE_TIERS}")
        if self.flow == "rao.cxl" and self.pattern not in ("CENTRAL",
                                                           "STRIDE1"):
            raise ValueError(
                "batch rao.cxl supports deterministic patterns "
                "CENTRAL|STRIDE1; use nic.CXLNicRAO (DES) for random ones")
        if self.n_requests < 1:
            raise ValueError("n_requests >= 1")


@dataclass
class SweepResult:
    """Structure-of-arrays result, aligned with ``points``."""
    points: List[SweepPoint]
    median_latency_ns: np.ndarray
    mean_latency_ns: np.ndarray
    bandwidth_GBs: np.ndarray
    extra: List[Dict[str, float]] = field(default_factory=list)

    def __len__(self):
        return len(self.points)

    def records(self) -> List[Dict]:
        out = []
        for i, pt in enumerate(self.points):
            rec = {
                "flow": pt.flow, "pattern": pt.pattern, "mode": pt.mode,
                "size": pt.size, "numa_node": pt.numa_node,
                "median_latency_ns": float(self.median_latency_ns[i]),
                "mean_latency_ns": float(self.mean_latency_ns[i]),
                "bandwidth_GBs": float(self.bandwidth_GBs[i]),
            }
            rec.update(self.extra[i])
            out.append(rec)
        return out


def _xp(backend: str):
    if backend == "numpy":
        return np
    raise ValueError(f"backend must be 'numpy' (the jax backend is a later "
                     f"slice of the port), got {backend!r}")


def _gather(pts: Sequence[SweepPoint], attr: str) -> np.ndarray:
    return np.array([getattr(p.params, attr) for p in pts], dtype=np.float64)


def _median_arith(base, step, n):
    """Median of the arithmetic sequence base + i*step, i in [0, n) — the
    exact TraceStats.median of a deterministic pipelined probe."""
    return base + step * (n - 1) / 2.0


# ------------------------------------------------------------- cxl.cache
def _eval_cxl_cache(pts: List[SweepPoint], xp) -> Dict[str, np.ndarray]:
    # single-access tier latencies come from the SimCXLParams properties
    # (the same ones the DES uses) so the composition lives in one place
    lat_hmc = _gather(pts, "lat_hmc_hit")
    lat_llc = _gather(pts, "lat_llc_hit")
    lat_mem = _gather(pts, "lat_mem_hit")
    o_hmc = _gather(pts, "hmc_issue_ns")
    o_llc = _gather(pts, "llc_issue_ns")
    o_mem = _gather(pts, "mem_issue_ns")
    line = _gather(pts, "line_bytes")
    numa = np.array([p.params.numa_extra_ns[p.numa_node] for p in pts])
    n = np.array([p.n_requests for p in pts], dtype=np.float64)

    tier = np.array([_CACHE_TIERS.index(p.pattern) for p in pts])
    is_hmc, is_llc, is_mem = tier == 0, tier == 1, tier == 2

    base = xp.where(is_hmc, lat_hmc,
                    xp.where(is_llc, lat_llc, lat_mem + numa))
    # bottleneck stage occupancy along each tier's path
    occ = xp.where(is_hmc, o_hmc,
                   xp.where(is_llc, xp.maximum(o_hmc, o_llc),
                            xp.maximum(xp.maximum(o_hmc, o_llc), o_mem)))

    is_bw = np.array([p.mode == "bandwidth" for p in pts])
    # latency mode: every request sees the unloaded path latency.
    # bandwidth mode: request i completes at i*occ + base.
    med = xp.where(is_bw, _median_arith(base, occ, n), base)
    mean = np.array(med, dtype=np.float64)  # copy: jitter loop writes both
    per_req = xp.where(is_bw, occ, base)          # PMU-window spacing
    bw = xp.where(n > 1, line / per_req, line / base)

    med, mean, bw, base, occ = (np.asarray(v, dtype=np.float64)
                                for v in (med, mean, bw, base, occ))

    # exact replication of the DES jitter draws (mem tier adds
    # uniform(0, numa_jitter_ns) per request, from random.Random(seed))
    for i, pt in enumerate(pts):
        if not (pt.jitter and pt.pattern == "mem"):
            continue
        rng = random.Random(pt.seed)
        j = pt.params.numa_jitter_ns
        u = np.array([rng.uniform(0.0, j) for _ in range(pt.n_requests)])
        if pt.mode == "bandwidth":
            lats = base[i] + occ[i] * np.arange(pt.n_requests) + u
            dones = lats                     # issued at t=0
        else:
            lats = base[i] + u
            dones = np.cumsum(lats)
        s = np.sort(lats)
        m = len(s)
        med[i] = s[m // 2] if m % 2 else 0.5 * (s[m // 2 - 1] + s[m // 2])
        mean[i] = lats.mean()
        d = np.sort(dones)
        if m >= 2:
            bw[i] = line[i] * (m - 1) / (d[-1] - d[0])
        else:
            bw[i] = line[i] / d[-1]

    hit = np.where(is_hmc, 1.0, 0.0)
    return {"median": med, "mean": mean, "bw": bw,
            "extra": [{"hmc_hit_rate": float(h)} for h in hit]}


# ------------------------------------------------------------ cxl.io.dma
def _eval_dma(pts: List[SweepPoint], xp) -> Dict[str, np.ndarray]:
    size = np.array([p.size for p in pts], dtype=np.float64)
    n = np.array([p.n_requests for p in pts], dtype=np.float64)
    lat = _gather(pts, "dma_setup_ns") + size / _gather(pts, "dma_wire_bw_GBs")
    occ = xp.maximum(_gather(pts, "dma_per_msg_overhead_ns"),
                     size / _gather(pts, "dma_stream_bw_GBs"))

    is_bw = np.array([p.mode == "bandwidth" for p in pts])
    med = xp.where(is_bw, _median_arith(lat, occ, n), lat)
    bw = xp.where(is_bw & (n > 1), size / occ, size / lat)
    med, bw = np.asarray(med, np.float64), np.asarray(bw, np.float64)
    return {"median": med, "mean": med.copy(), "bw": bw,
            "extra": [{} for _ in pts]}


# ----------------------------------------------------------- cxl.io.mmio
def _eval_mmio(pts: List[SweepPoint], xp) -> Dict[str, np.ndarray]:
    w = _gather(pts, "mmio_write_ns")
    r = _gather(pts, "mmio_read_ns")
    is_read = np.array([p.pattern == "read" for p in pts])
    lat = np.asarray(xp.where(is_read, r, w), np.float64)
    size = np.array([p.size for p in pts], dtype=np.float64)
    return {"median": lat, "mean": lat.copy(), "bw": size / lat,
            "extra": [{} for _ in pts]}


# ------------------------------------------------------------------- rao
def _eval_rao_cxl(pts: List[SweepPoint], xp) -> Dict[str, np.ndarray]:
    from repro_torch.simcxl.nic import RAO_HIT_LOOKUP_CYCLES
    cyc = 1e9 / _gather(pts, "device_freq_hz")
    pe = _gather(pts, "rao_pe_cycles")
    hit_ns = (RAO_HIT_LOOKUP_CYCLES + pe) * cyc    # nic.CXLNicRAO.hit_cycles
    miss_ns = (_gather(pts, "pcie_traversal_ns")
               + _gather(pts, "llc_access_ns")
               + _gather(pts, "dram_access_ns"))
    line = _gather(pts, "line_bytes")
    n = np.array([p.n_requests for p in pts], dtype=np.float64)

    is_central = np.array([p.pattern == "CENTRAL" for p in pts])
    # CENTRAL: one cold miss, then the line stays M in the HMC.
    # STRIDE1: sequential u64 atomics — one miss per distinct cache line.
    misses = xp.where(is_central, 1.0, np.ceil(n * ELEM / line))
    total = n * hit_ns + misses * miss_ns
    per_op = total / n
    hit_rate = (n - misses) / n
    return {"median": np.asarray(per_op, np.float64),
            "mean": np.asarray(per_op, np.float64),
            "bw": np.asarray(ELEM / per_op, np.float64),
            "extra": [{"total_ns": float(t), "hmc_hit_rate": float(h),
                       "mops": float(nn / t * 1e3)}
                      for t, h, nn in zip(np.asarray(total),
                                          np.asarray(hit_rate), n)]}


def _eval_rao_pcie(pts: List[SweepPoint], xp) -> Dict[str, np.ndarray]:
    cyc = 1e9 / _gather(pts, "device_freq_hz")
    per_op = (_gather(pts, "rao_pcie_read_ns")
              + _gather(pts, "line_bytes") / _gather(pts, "dma_wire_bw_GBs")
              + _gather(pts, "rao_pe_cycles") * cyc
              + _gather(pts, "rao_pcie_write_ns"))
    n = np.array([p.n_requests for p in pts], dtype=np.float64)
    total = per_op * n
    return {"median": np.asarray(per_op, np.float64),
            "mean": np.asarray(per_op, np.float64),
            "bw": np.asarray(ELEM / per_op, np.float64),
            "extra": [{"total_ns": float(t), "mops": float(nn / t * 1e3)}
                      for t, nn in zip(total, n)]}


_EVAL = {
    "cxl.cache": _eval_cxl_cache,
    "cxl.io.dma": _eval_dma,
    "cxl.io.mmio": _eval_mmio,
    "rao.cxl": _eval_rao_cxl,
    "rao.pcie": _eval_rao_pcie,
}


# ------------------------------------------------------------------ sweep
def sweep(points: Iterable[SweepPoint], *,
          backend: str = "numpy") -> SweepResult:
    """Evaluate many SimCXL flow points as one array program.

    Points are grouped by flow and each group is evaluated vectorized; the
    result arrays are aligned with the input order and are always numpy
    (results materialize eagerly — sweep() is NOT jit/grad-traceable).
    Only ``backend="numpy"`` exists in this package.
    """
    points = list(points)
    for pt in points:
        pt.validate()
    xp = _xp(backend)

    n = len(points)
    med = np.zeros(n)
    mean = np.zeros(n)
    bw = np.zeros(n)
    extra: List[Dict] = [{} for _ in range(n)]

    by_flow: Dict[str, List[int]] = {}
    for i, pt in enumerate(points):
        by_flow.setdefault(pt.flow, []).append(i)

    for flow, idx in by_flow.items():
        group = [points[i] for i in idx]
        out = _EVAL[flow](group, xp)
        med[idx] = out["median"]
        mean[idx] = out["mean"]
        bw[idx] = out["bw"]
        for j, i in enumerate(idx):
            extra[i] = out["extra"][j]

    return SweepResult(points, med, mean, bw, extra)


def grid(*, flow: str, patterns: Sequence[str] = ("mem",),
         modes: Sequence[str] = ("latency",),
         sizes: Sequence[int] = (64,),
         numa_nodes: Sequence[int] = (7,),
         params: Sequence[SimCXLParams] = (FPGA_400MHZ,),
         n_requests: int = 32, jitter: bool = False,
         seed: int = 0) -> List[SweepPoint]:
    """Cartesian-product point builder for one flow."""
    return [SweepPoint(flow=flow, pattern=pat, mode=mode, size=size,
                       numa_node=node, params=p, n_requests=n_requests,
                       jitter=jitter, seed=seed)
            for p in params for pat in patterns for mode in modes
            for size in sizes for node in numa_nodes]


def frequency_sweep(freqs_hz: Sequence[float],
                    base: SimCXLParams = FPGA_400MHZ,
                    tiers: Sequence[str] = _CACHE_TIERS,
                    modes: Sequence[str] = ("latency", "bandwidth"),
                    n_requests: int = 32) -> SweepResult:
    """Device-frequency design-space sweep (the paper's FPGA->ASIC axis),
    evaluated entirely on the batch path."""
    pts = grid(flow="cxl.cache", patterns=tuple(tiers), modes=tuple(modes),
               params=tuple(base.at_freq(f) for f in freqs_hz),
               n_requests=n_requests)
    return sweep(pts)
