"""Set-associative HMC (host-memory cache) model with MESI-lite states.

Matches the testbed device: 128 KB, 4-way, 64 B lines (Table I).  The cache
is the device-side coherence participant (peer of CPU L2); the LLC holds the
directory (see ``coherence.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple


class State(str, Enum):
    M = "M"
    E = "E"
    S = "S"
    I = "I"  # noqa: E741


@dataclass
class Line:
    tag: int
    state: State
    lru: int
    data: Optional[int] = None   # functional payload (for tests)


class SetAssocCache:
    def __init__(self, size_bytes: int = 128 * 1024, ways: int = 4,
                 line_bytes: int = 64):
        self.line_bytes = line_bytes
        self.ways = ways
        self.n_sets = size_bytes // (ways * line_bytes)
        assert self.n_sets & (self.n_sets - 1) == 0, "pow2 sets"
        self.sets: list = [[] for _ in range(self.n_sets)]
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.writebacks = 0

    def _index(self, addr: int) -> Tuple[int, int]:
        line = addr // self.line_bytes
        return line % self.n_sets, line // self.n_sets

    def lookup(self, addr: int) -> Optional[Line]:
        s, tag = self._index(addr)
        for ln in self.sets[s]:
            if ln.tag == tag and ln.state != State.I:
                self._tick += 1
                ln.lru = self._tick
                return ln
        return None

    def probe(self, addr: int) -> Optional[Line]:
        """Lookup without LRU update (snoops)."""
        s, tag = self._index(addr)
        for ln in self.sets[s]:
            if ln.tag == tag and ln.state != State.I:
                return ln
        return None

    def access(self, addr: int, write: bool) -> Tuple[bool, Optional[Line]]:
        """Returns (hit, victim_line_if_dirty_evict)."""
        ln = self.lookup(addr)
        if ln is not None:
            self.hits += 1
            if write:
                ln.state = State.M     # silent E->M upgrade; S needs upgrade
            return True, None
        self.misses += 1
        victim = self.fill(addr, State.M if write else State.E)
        return False, victim

    def fill(self, addr: int, state: State) -> Optional[Line]:
        """Install a line; returns evicted dirty line (needs writeback)."""
        s, tag = self._index(addr)
        st = self.sets[s]
        self._tick += 1
        for ln in st:                      # reuse an invalid way
            if ln.state == State.I:
                ln.tag, ln.state, ln.lru = tag, state, self._tick
                return None
        if len(st) < self.ways:
            st.append(Line(tag, state, self._tick))
            return None
        victim = min(st, key=lambda l: l.lru)
        self.evictions += 1
        dirty = victim.state == State.M
        if dirty:
            self.writebacks += 1
        out = Line(victim.tag, victim.state, victim.lru, victim.data)
        victim.tag, victim.state, victim.lru, victim.data = \
            tag, state, self._tick, None
        return out if dirty else None

    def invalidate(self, addr: int) -> bool:
        """Snoop-invalidate; returns True if a dirty line was dropped."""
        ln = self.probe(addr)
        if ln is None:
            return False
        dirty = ln.state == State.M
        ln.state = State.I
        return dirty

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def reset_stats(self):
        self.hits = self.misses = self.evictions = self.writebacks = 0
