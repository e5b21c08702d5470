"""Remote Atomic Operations (paper §V-A) — engine + TPU-native analogue.

``RAOEngine`` executes FAA/CAS/SWAP/logical/min-max atomics against the
coherent pool with the CXL-NIC semantics: the PE locks the target cacheline
in the HMC for the read-modify-write, coherence keeps the host's view fresh.

Ordering guarantee — **per-address, not global**: the PE lock serializes
the read-modify-writes that touch one address, so every execution is
equivalent to *some* sequential order (its own completion order), even for
non-commutative mixes (CAS/SWAP interleaved with FAA).  Nothing orders
operations on *different* addresses relative to each other — two engines
given the same request list may interleave addresses differently and land
in different (individually linearizable) final states.  Consumers that need
cross-address ordering must build it from single-address primitives — the
serving runtime's ticket handoff does exactly this: the prefill-slot and
decode-slot counters are separate FAA addresses, and each counter alone
orders its claims.  Property-tested in tests/test_core.py (arbitrary
interleavings == the sequential oracle replayed in completion order).

The mesh fetch-and-add over a replicated counter and the bulk atomic
scatter-accumulate kernel belong to the mesh/RAO slice of the port.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

RAO_OPS: Dict[str, Callable[[int, int], int]] = {
    "FAA": lambda old, arg: old + arg,
    "SWAP": lambda old, arg: arg,
    "FAND": lambda old, arg: old & arg,
    "FOR": lambda old, arg: old | arg,
    "FXOR": lambda old, arg: old ^ arg,
    "MIN": lambda old, arg: min(old, arg),
    "MAX": lambda old, arg: max(old, arg),
}


@dataclass
class RAORequest:
    op: str
    addr: int
    arg: int
    arg2: int = 0     # CAS expected value


class RAOEngine:
    """Functional RAO engine over a word-addressed memory with per-line
    locking (the CXL-NIC PE flow of Fig 9)."""

    def __init__(self, line_bytes: int = 64):
        self.mem: Dict[int, int] = {}
        self.line_bytes = line_bytes
        self.locked: set = set()
        self.completed: List[Tuple[RAORequest, int]] = []

    def _line(self, addr: int) -> int:
        return addr - addr % self.line_bytes

    def execute(self, req: RAORequest) -> int:
        """Executes one RAO atomically; returns the OLD value."""
        line = self._line(req.addr)
        assert line not in self.locked, "PE lock violated"
        self.locked.add(line)           # lock cacheline (prevents invalidation)
        try:
            old = self.mem.get(req.addr, 0)
            if req.op == "CAS":
                if old == req.arg2:
                    self.mem[req.addr] = req.arg
            else:
                self.mem[req.addr] = RAO_OPS[req.op](old, req.arg)
            self.completed.append((req, old))
            return old
        finally:
            self.locked.discard(line)

    def run_schedule(self, reqs: List[RAORequest],
                     seed: Optional[int] = None) -> List[int]:
        """Executes requests in a (possibly shuffled) order — models
        concurrent PEs whose per-address order is serialized by the lock."""
        order = list(range(len(reqs)))
        if seed is not None:
            random.Random(seed).shuffle(order)
        results = [0] * len(reqs)
        for i in order:
            results[i] = self.execute(reqs[i])
        return results


def sequential_oracle(reqs: List[RAORequest]) -> Dict[int, int]:
    """Final memory state under program order (for commutative op sets any
    order gives the same final state — the linearizability property)."""
    mem: Dict[int, int] = {}
    for r in reqs:
        old = mem.get(r.addr, 0)
        if r.op == "CAS":
            if old == r.arg2:
                mem[r.addr] = r.arg
        else:
            mem[r.addr] = RAO_OPS[r.op](old, r.arg)
    return mem
