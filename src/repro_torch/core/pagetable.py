"""Unified per-process page table + device ATC (paper §III-C).

Cohet's key OS mechanism: CPU and XPU threads share ONE page table.  XPU
translations go through a device-side Address Translation Cache (ATC);
misses walk the shared table via the IOMMU.  Page migration / swap follows
the HMM flow: block the device, update the PTE, invalidate the ATC entries
(ATS invalidation), then resume — property-tested in
tests/test_core_pagetable.py (no stale translation is ever visible).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, List, Optional

PAGE = 4096


@dataclass
class PTE:
    vpage: int
    tier: str                 # 'hbm' | 'host' | 'cxl'
    frame: int
    present: bool = True
    dirty: bool = False
    access_count: int = 0


class ATC:
    """Device-side translation cache (LRU, bounded)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._map: "collections.OrderedDict[int, PTE]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def lookup(self, vpage: int) -> Optional[PTE]:
        pte = self._map.get(vpage)
        if pte is not None:
            self._map.move_to_end(vpage)
            self.hits += 1
        else:
            self.misses += 1
        return pte

    def install(self, pte: PTE):
        self._map[pte.vpage] = pte
        self._map.move_to_end(pte.vpage)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)

    def invalidate(self, vpage: int):
        self.invalidations += 1
        self._map.pop(vpage, None)

    def invalidate_all(self):
        self.invalidations += len(self._map)
        self._map.clear()


class DeviceContext:
    def __init__(self, name: str, atc_capacity: int = 64):
        self.name = name
        self.atc = ATC(atc_capacity)
        self.blocked = False


class UnifiedPageTable:
    """One page table shared by all compute contexts of a process."""

    def __init__(self):
        self.ptes: Dict[int, PTE] = {}
        self.devices: Dict[str, DeviceContext] = {}
        self.walks = 0

    def register_device(self, name: str, atc_capacity: int = 64) -> DeviceContext:
        ctx = DeviceContext(name, atc_capacity)
        self.devices[name] = ctx
        return ctx

    # ---- allocation (malloc creates PTEs without frames: overcommit) ----
    def map_range(self, vpage0: int, n_pages: int):
        for i in range(n_pages):
            vp = vpage0 + i
            assert vp not in self.ptes, f"double map of vpage {vp}"
            self.ptes[vp] = PTE(vp, tier="unbound", frame=-1, present=False)

    def unmap_range(self, vpage0: int, n_pages: int):
        for i in range(n_pages):
            vp = vpage0 + i
            self.ptes.pop(vp, None)
            for d in self.devices.values():
                d.atc.invalidate(vp)

    # ---- translation ----
    def walk(self, vpage: int) -> Optional[PTE]:
        """IOMMU page-table walk."""
        self.walks += 1
        return self.ptes.get(vpage)

    def translate_host(self, vpage: int) -> Optional[PTE]:
        pte = self.ptes.get(vpage)
        if pte is None or not pte.present:
            return None
        pte.access_count += 1
        return pte

    def translate_device(self, dev: str, vpage: int) -> Optional[PTE]:
        """ATS flow: ATC hit, else IOMMU walk + install (paper Fig 3)."""
        ctx = self.devices[dev]
        assert not ctx.blocked, "device access while blocked (HMM violation)"
        pte = ctx.atc.lookup(vpage)
        if pte is not None and pte.present:
            pte.access_count += 1
            return pte
        pte = self.walk(vpage)
        if pte is None or not pte.present:
            return None
        ctx.atc.install(pte)
        pte.access_count += 1
        return pte

    # ---- HMM update protocol (migration / swap) ----
    def update_pte(self, vpage: int, *, tier: str, frame: int):
        """Safely update a PTE: block devices -> update -> ATS invalidate ->
        resume (the paper's driver-callback sequence)."""
        for d in self.devices.values():
            d.blocked = True
        try:
            pte = self.ptes[vpage]
            pte.tier = tier
            pte.frame = frame
            pte.present = True
            for d in self.devices.values():
                d.atc.invalidate(vpage)
        finally:
            for d in self.devices.values():
                d.blocked = False

    def bind(self, vpage: int, tier: str, frame: int):
        """First-touch binding (no invalidation needed: was not present)."""
        pte = self.ptes[vpage]
        pte.tier, pte.frame, pte.present = tier, frame, True

    def check_no_stale_atc(self) -> List[str]:
        """Invariant: every ATC entry matches the authoritative PTE."""
        errs = []
        for d in self.devices.values():
            for vp, cached in d.atc._map.items():
                auth = self.ptes.get(vp)
                if auth is None:
                    errs.append(f"{d.name}: ATC holds unmapped vpage {vp}")
                elif cached is not auth:
                    errs.append(f"{d.name}: stale ATC object for vpage {vp}")
        return errs
