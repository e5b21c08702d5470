"""Cohet coherent memory pool: tiered malloc/mmap with auto-migration.

The paper's S1/S4: compute and memory decouple into pools; applications call
plain ``malloc`` and the OS binds pages on first touch, migrates hot pages,
and overcommits beyond any single tier.  Here the pool manages three tiers
(device HBM / host DRAM / CXL expander) over the UnifiedPageTable, with a
calibrated cost model (SimCXL latencies) scoring placements.  The JAX
integration (``repro_torch.core.placement``) uses the same pool to plan where a
training job's params / optimizer state / KV cache live.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.pagetable import PAGE, UnifiedPageTable
from repro_torch.simcxl.params import FPGA_400MHZ, SimCXLParams


@dataclass
class Tier:
    name: str
    capacity_bytes: int
    used_bytes: int = 0
    # calibrated per-access characteristics
    load_latency_ns: float = 0.0
    stream_bw_GBs: float = 0.0

    @property
    def free_bytes(self):
        return self.capacity_bytes - self.used_bytes


@dataclass
class Allocation:
    vaddr: int
    size: int
    name: str
    hint: str = "auto"     # auto | hot | cold | stream
    refs: int = 1          # coherent sharers; physical release at zero


class CoherentMemoryPool:
    """Unified, coherent, tiered memory pool with page auto-migration."""

    # hbm_bytes and the hbm tier's stream rate default to the reference
    # package's values (CPU runs); on a CUDA card the serving engine sets
    # the card's capacity and stream rate (repro_torch.device)
    def __init__(self, *, hbm_bytes: int = 16 << 30,
                 host_bytes: int = 256 << 30,
                 cxl_bytes: int = 512 << 30,
                 params: SimCXLParams = FPGA_400MHZ,
                 migrate_threshold: int = 8):
        p = params
        self.tiers: Dict[str, Tier] = {
            "hbm": Tier("hbm", hbm_bytes, load_latency_ns=p.dcyc(p.hmc_hit_cycles),
                        stream_bw_GBs=819.0),
            "host": Tier("host", host_bytes, load_latency_ns=p.lat_mem_hit,
                         stream_bw_GBs=p.dma_stream_bw_GBs),
            "cxl": Tier("cxl", cxl_bytes,
                        load_latency_ns=p.lat_mem_hit + p.numa_extra_ns[0],
                        stream_bw_GBs=p.dma_stream_bw_GBs * 0.8),
        }
        self.pt = UnifiedPageTable()
        self.allocs: Dict[int, Allocation] = {}
        self._next_vaddr = PAGE              # vaddr 0 reserved
        self._frames = {t: itertools.count() for t in self.tiers}
        self.migrations = 0
        self.faults = 0
        self.migrate_threshold = migrate_threshold
        self.data: Dict[int, int] = {}       # functional store vaddr->byte val

    # ------------------------------------------------------------- malloc
    def malloc(self, size: int, name: str = "", hint: str = "auto") -> int:
        """Standard malloc: reserves VA + PTEs, binds NO physical frames
        (overcommit, first-touch binding) — paper §III-C2."""
        size = max(size, 1)
        n_pages = -(-size // PAGE)
        vaddr = self._next_vaddr
        self._next_vaddr += n_pages * PAGE
        self.pt.map_range(vaddr // PAGE, n_pages)
        self.allocs[vaddr] = Allocation(vaddr, size, name, hint)
        return vaddr

    mmap = malloc

    def incref(self, vaddr: int):
        """Add a coherent sharer to an allocation.  The pool is a single
        physical arena — sharing a region costs no frames, only a refcount;
        ``free`` drops one reference and releases frames at zero.  (This is
        what makes prefix-shared KV pages honest in the accounting: one
        allocation, many page-table rows.)"""
        self.allocs[vaddr].refs += 1

    def free(self, vaddr: int):
        al = self.allocs[vaddr]
        if al.refs > 1:                      # other sharers still hold it
            al.refs -= 1
            return
        del self.allocs[vaddr]
        n_pages = -(-al.size // PAGE)
        for i in range(n_pages):
            pte = self.pt.ptes.get(vaddr // PAGE + i)
            if pte is not None and pte.present:
                self.tiers[pte.tier].used_bytes -= PAGE
        self.pt.unmap_range(vaddr // PAGE, n_pages)

    # ------------------------------------------------------------- access
    def _first_touch_tier(self, requester: str, hint: str) -> str:
        order = {
            "hbm": ("hbm", "host", "cxl"),
            "host": ("host", "cxl", "hbm"),
        }.get("hbm" if requester.startswith("xpu") else "host")
        if hint == "cold":
            order = ("cxl", "host", "hbm")
        if hint == "stream":
            order = ("host", "cxl", "hbm")
        for t in order:
            if self.tiers[t].free_bytes >= PAGE:
                return t
        raise MemoryError("pool exhausted")

    def _bind(self, vpage: int, requester: str, hint: str):
        tier = self._first_touch_tier(requester, hint)
        frame = next(self._frames[tier])
        self.tiers[tier].used_bytes += PAGE
        self.pt.bind(vpage, tier, frame)
        self.faults += 1

    def _alloc_of(self, vaddr: int) -> Allocation:
        al = self.allocs.get(vaddr)
        if al is not None:               # base address: O(1), the common
            return al                    # case (block pagers touch bases)
        for base, al in self.allocs.items():
            if base <= vaddr < base + al.size:
                return al
        raise KeyError(f"wild pointer {vaddr:#x}")

    def access(self, requester: str, vaddr: int, *, write: bool = False,
               value: Optional[int] = None) -> Tuple[Optional[int], float]:
        """Coherent load/store from a CPU ('cpu*') or XPU ('xpu*') thread.
        Returns (value, latency_ns)."""
        al = self._alloc_of(vaddr)
        vpage = vaddr // PAGE
        pte = self.pt.ptes[vpage]
        if not pte.present:
            self._bind(vpage, requester, al.hint)
        if requester.startswith("xpu"):
            pte = self.pt.translate_device(requester, vpage)
        else:
            pte = self.pt.translate_host(vpage)
        tier = self.tiers[pte.tier]
        lat = tier.load_latency_ns
        if write:
            pte.dirty = True
            self.data[vaddr] = value
            return None, lat
        return self.data.get(vaddr), lat

    # ---------------------------------------------------------- migration
    def migrate(self, vaddr: int, tier: str):
        """Explicitly move an allocation's bound pages to ``tier`` (the KV
        tiering engine's demote/promote path — policy lives in the caller,
        the pool just re-binds frames and keeps the accounting honest).
        Unbound (never-touched) pages stay unbound: first touch still
        decides their initial placement.  Raises MemoryError when the
        destination tier cannot hold the allocation's present pages."""
        if tier not in self.tiers:
            raise KeyError(f"unknown tier {tier!r}")
        al = self.allocs[vaddr]
        n_pages = -(-al.size // PAGE)
        ptes = [p for p in (self.pt.ptes.get(vaddr // PAGE + i)
                            for i in range(n_pages))
                if p is not None and p.present and p.tier != tier]
        need = len(ptes) * PAGE
        if self.tiers[tier].free_bytes < need:
            raise MemoryError(f"tier {tier} full: need {need} bytes, "
                              f"free {self.tiers[tier].free_bytes}")
        for pte in ptes:
            self.tiers[pte.tier].used_bytes -= PAGE
            self.tiers[tier].used_bytes += PAGE
            self.pt.update_pte(pte.vpage, tier=tier,
                               frame=next(self._frames[tier]))
        self.migrations += len(ptes)
        return len(ptes)

    def maybe_migrate(self):
        """Hot-page promotion / cold-page demotion (HMM driver callback:
        block device -> update PTE -> ATS invalidate -> resume)."""
        moved = 0
        for pte in list(self.pt.ptes.values()):
            if not pte.present:
                continue
            if pte.tier != "hbm" and pte.access_count >= self.migrate_threshold:
                if self.tiers["hbm"].free_bytes >= PAGE:
                    self.tiers[pte.tier].used_bytes -= PAGE
                    self.tiers["hbm"].used_bytes += PAGE
                    self.pt.update_pte(pte.vpage, tier="hbm",
                                       frame=next(self._frames["hbm"]))
                    pte.access_count = 0
                    moved += 1
        self.migrations += moved
        return moved

    # ---------------------------------------------------------- reporting
    def stats(self) -> dict:
        return {
            "tiers": {t.name: {"used": t.used_bytes, "cap": t.capacity_bytes}
                      for t in self.tiers.values()},
            "faults": self.faults,
            "migrations": self.migrations,
            "shared": {
                "allocs": sum(1 for a in self.allocs.values() if a.refs > 1),
                "extra_refs": sum(a.refs - 1 for a in self.allocs.values()),
                "bytes": sum(a.size for a in self.allocs.values()
                             if a.refs > 1),
            },
            "atc": {d: (ctx.atc.hits, ctx.atc.misses, ctx.atc.invalidations)
                    for d, ctx in self.pt.devices.items()},
        }
