"""Pluggable SimCXL NIC cost model for the serving engine (paper §V/Fig 18).

The serving loop's host-side RPC work — request deserialization, response
serialization, and the RAO slot-ticket claims — is exactly the traffic the
paper's CXL-NIC offloads.  This module projects, per batch and for the whole
run, what that traffic would cost on a PCIe-NIC (RpcNIC: DMA + doorbells +
DSA) vs the CXL-NIC (NC-P pushes into the LLC, CXL.mem message construction,
HMC-cached atomics), using:

* the calibrated RPC pipeline models in ``simcxl.nic`` for the
  (de)serialization stages, fed by ``core.rpc.message_profile`` statistics
  of the *actual wire messages* the server moved;
* the vectorized ``simcxl.batch.sweep`` engine for the ticket-claim RAO
  batches (CENTRAL pattern — every claim hits the same counter line).

The model is pure accounting: it never touches the serving data path, so it
can stay enabled in production and is cheap (one closed-form evaluation per
scheduler event).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict

from repro_torch.core import rpc as wire
from repro_torch.simcxl.batch import SweepPoint, sweep
from repro_torch.simcxl.nic import (
    RpcBench, cxlnic_deserialize_ns, cxlnic_serialize_mem_ns,
    rpcnic_deserialize_ns, rpcnic_serialize_ns,
)
from repro_torch.simcxl.params import FPGA_400MHZ, SimCXLParams


def profile_to_bench(profile: Dict, name: str = "serve",
                     n_msgs: int = 1) -> RpcBench:
    """``core.rpc.message_profile`` output -> a SimCXL RPC bench point."""
    n_fields = max(1, profile["n_fields"])
    field_bytes = max(1, profile["payload_bytes"] // n_fields)
    return RpcBench(name, n_fields=n_fields, field_bytes=field_bytes,
                    nesting=max(1, profile["nesting"]), n_msgs=n_msgs)


@dataclass
class BatchCost:
    """Projected host-side NIC cost of one scheduler event batch (ns)."""
    kind: str        # ingress | egress | ticket | kv_share/migrate/handoff
    n: int
    pcie_ns: float
    cxl_ns: float

    @property
    def speedup(self) -> float:
        return self.pcie_ns / self.cxl_ns if self.cxl_ns else float("inf")


class NicCostModel:
    """Accumulates projected CXL-NIC vs PCIe-NIC cost over a serving run."""

    def __init__(self, params: SimCXLParams = FPGA_400MHZ,
                 keep_batches: int = 256):
        self.p = params
        self.totals = {"ingress": [0.0, 0.0], "egress": [0.0, 0.0],
                       "ticket": [0.0, 0.0],
                       "kv_share": [0.0, 0.0],
                       "kv_migrate": [0.0, 0.0],
                       "kv_handoff": [0.0, 0.0]}      # kind -> [pcie, cxl]
        self.counts = {"ingress": 0, "egress": 0, "ticket": 0,
                       "kv_share": 0, "kv_migrate": 0, "kv_handoff": 0}
        # most-recent ring: keeping only the *first* keep_batches batches
        # would leave report()["per_batch"] permanently warmup-biased on
        # long runs (the first batches carry compile + cold-cache costs)
        self.batches: Deque[BatchCost] = deque(maxlen=keep_batches)
        self._keep = keep_batches

    # ------------------------------------------------------------ events
    def _record(self, kind: str, n: int, pcie_ns: float, cxl_ns: float):
        self.totals[kind][0] += pcie_ns
        self.totals[kind][1] += cxl_ns
        self.counts[kind] += n
        self.batches.append(BatchCost(kind, n, pcie_ns, cxl_ns))

    def on_ingress(self, msg: Dict):
        """A decoded request message entered the server."""
        b = profile_to_bench(wire.message_profile(msg), "ingress")
        self._record("ingress", 1, rpcnic_deserialize_ns(self.p, b),
                     cxlnic_deserialize_ns(self.p, b))

    def on_egress(self, msg: Dict):
        """A response message left the server (serialization path)."""
        b = profile_to_bench(wire.message_profile(msg), "egress")
        self._record("egress", 1, rpcnic_serialize_ns(self.p, b),
                     cxlnic_serialize_mem_ns(self.p, b))

    def on_ticket_batch(self, n_claims: int):
        """`n_claims` FAA ticket claims against the shared slot counter —
        the CENTRAL RAO pattern, evaluated on the batch sweep engine."""
        if n_claims < 1:
            return
        pts = [SweepPoint("rao.cxl", "CENTRAL", n_requests=n_claims,
                          params=self.p),
               SweepPoint("rao.pcie", "CENTRAL", n_requests=n_claims,
                          params=self.p)]
        res = sweep(pts)
        cxl_ns = res.extra[0]["total_ns"]
        pcie_ns = res.extra[1]["total_ns"]
        self._record("ticket", n_claims, pcie_ns, cxl_ns)

    def on_prefix_share(self, n_blocks: int, block_bytes: int):
        """A prefix-cache hit mapped ``n_blocks`` shared KV pool pages into
        a new request instead of re-prefilling them.  The request then
        *reads* those bytes coherently during attention — cacheline-
        granular irregular traffic, exactly the regime where the paper's
        CXL.cache path wins (Figs 13-16 crossover: sub-8KB granules).  The
        PCIe alternative is a per-consumer DMA copy of the same bytes at
        line granularity, paying the per-message overhead on every line —
        the 14.4x bandwidth gap that makes fine-grained page sharing
        viable only on the coherent fabric."""
        if n_blocks < 1:
            return
        total = n_blocks * block_bytes
        line = int(self.p.line_bytes)
        n_lines = max(1, -(-total // line))
        pts = [SweepPoint("cxl.cache", "mem", mode="bandwidth", size=line,
                          n_requests=n_lines, params=self.p),
               SweepPoint("cxl.io.dma", mode="bandwidth", size=line,
                          n_requests=n_lines, params=self.p)]
        res = sweep(pts)
        # bandwidth_GBs is bytes/ns at the sweep's steady state; neither
        # flow exposes extra["total_ns"], so project totals from it
        cxl_ns = total / max(res.bandwidth_GBs[0], 1e-12)
        pcie_ns = total / max(res.bandwidth_GBs[1], 1e-12)
        self._record("kv_share", n_blocks, pcie_ns, cxl_ns)

    def on_kv_migrate(self, n_blocks: int, block_bytes: int):
        """``n_blocks`` KV pool pages moved between the near (HBM) and far
        (CXL) arenas by the tiering engine.  On the coherent fabric a
        migration is a stream of cacheline writes into the far tier
        (cxl.cache mem flow); the PCIe alternative is one DMA descriptor
        per block — same axis the demotion policy is scored on
        (``runtime.kvtier.derive_policy``)."""
        if n_blocks < 1:
            return
        total = n_blocks * block_bytes
        line = int(self.p.line_bytes)
        n_lines = max(1, -(-total // line))
        pts = [SweepPoint("cxl.cache", "mem", mode="bandwidth", size=line,
                          n_requests=n_lines, params=self.p),
               SweepPoint("cxl.io.dma", mode="bandwidth", size=block_bytes,
                          n_requests=n_blocks, params=self.p)]
        res = sweep(pts)
        cxl_ns = total / max(res.bandwidth_GBs[0], 1e-12)
        pcie_ns = total / max(res.bandwidth_GBs[1], 1e-12)
        self._record("kv_migrate", n_blocks, pcie_ns, cxl_ns)

    def on_kv_handoff(self, n_blocks: int, block_bytes: int):
        """``n_blocks`` finished prefill KV pages handed from the prefill
        worker to the decode worker.  On the coherent fabric the handoff is
        free of data movement — the decode worker maps the *same* pool
        pages, so only the per-block ownership metadata (block-table row
        entry + state word, one cacheline per page) crosses the fabric;
        the page contents are later demand-read by decode attention exactly
        as they would be without disaggregation.  The PCIe alternative has
        no shared pool: every page is re-copied to the decode node as one
        DMA descriptor per block — the disaggregation tax this event makes
        measurable."""
        if n_blocks < 1:
            return
        total = n_blocks * block_bytes
        line = int(self.p.line_bytes)
        pts = [SweepPoint("cxl.cache", "mem", mode="bandwidth", size=line,
                          n_requests=n_blocks, params=self.p),
               SweepPoint("cxl.io.dma", mode="bandwidth", size=block_bytes,
                          n_requests=n_blocks, params=self.p)]
        res = sweep(pts)
        meta_bytes = n_blocks * line
        cxl_ns = meta_bytes / max(res.bandwidth_GBs[0], 1e-12)
        pcie_ns = total / max(res.bandwidth_GBs[1], 1e-12)
        self._record("kv_handoff", n_blocks, pcie_ns, cxl_ns)

    # ------------------------------------------------------------ report
    def report(self) -> Dict:
        """Totals + headline: projected host NIC time per serving run."""
        out: Dict = {}
        tot_pcie = tot_cxl = 0.0
        for kind, (pcie, cxl) in self.totals.items():
            out[kind] = {
                "n": self.counts[kind],
                "pcie_us": pcie / 1e3,
                "cxl_us": cxl / 1e3,
                "speedup_x": round(pcie / cxl, 3) if cxl else None,
            }
            tot_pcie += pcie
            tot_cxl += cxl
        out["total"] = {
            "pcie_us": tot_pcie / 1e3,
            "cxl_us": tot_cxl / 1e3,
            "speedup_x": round(tot_pcie / tot_cxl, 3) if tot_cxl else None,
        }
        if self.batches:
            out["per_batch"] = {
                "n_recorded": len(self.batches),
                "pcie_us_mean": sum(b.pcie_ns for b in self.batches)
                / len(self.batches) / 1e3,
                "cxl_us_mean": sum(b.cxl_ns for b in self.batches)
                / len(self.batches) / 1e3,
            }
        return out


class NullNicCostModel:
    """Disabled cost model: same surface, zero work (for tight loops)."""

    def on_ingress(self, msg):
        pass

    def on_egress(self, msg):
        pass

    def on_ticket_batch(self, n_claims):
        pass

    def on_prefix_share(self, n_blocks, block_bytes):
        pass

    def on_kv_migrate(self, n_blocks, block_bytes):
        pass

    def on_kv_handoff(self, n_blocks, block_bytes):
        pass

    def report(self) -> Dict:
        return {"total": {"pcie_us": 0.0, "cxl_us": 0.0, "speedup_x": None}}
