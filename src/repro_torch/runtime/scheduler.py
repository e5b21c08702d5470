"""Slot-based continuous-batching scheduler (paper §V-A serving loop).

The pieces the serving engine composes:

* ``Request`` — per-request state machine
  ``QUEUED -> PREFILL -> DECODE -> DONE`` (``FAILED`` from any state), with
  arrival/admit/first-token/done timestamps for latency accounting;
* ``SlotTable`` — fixed decode slots claimed through the RAO fetch-and-add
  ticket sequencer (``core.rao`` — the paper's CENTRAL pattern,
  decentralized: no coordinator thread on the critical path);
* ``KVBlockPager`` — pages each slot's KV/state footprint through the
  ``core.pool.CoherentMemoryPool`` in fixed token blocks, with the tier
  decision (HBM vs coherent host/CXL) planned by ``core.placement`` and
  the projected per-touch latency scored from the SimCXL-calibrated tier
  constants; in block-table mode it additionally owns the real
  ``(n_slots, max_blocks)`` page table + free list that back the paged
  decode-attention kernel's pool reads;
* ``AdmissionQueue`` — FIFO admission with a family-aware policy: ssm
  (recurrent-state) models admit into any free slot at any tick (true
  continuous batching), and so do attention families on the paged KV
  plane (per-slot block tables + lengths); only the dense
  shared-write-index cache path (``paged_kv=False``) still restricts
  admissions to waves of equal prompt length.
"""
from __future__ import annotations

import enum
import time
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.placement import TensorClass, plan_placement
from repro_torch.core.pool import CoherentMemoryPool
from repro_torch.core.rao import RAOEngine, RAORequest
from repro_torch.runtime.kvtier import TierPolicy, derive_policy


class RequestState(enum.Enum):
    QUEUED = "QUEUED"
    PREFILL = "PREFILL"
    PREFILLING = "PREFILLING"    # chunked prefill in progress (multi-tick)
    HANDOFF = "HANDOFF"          # prefill done; awaiting a decode-worker slot
    DECODE = "DECODE"
    DONE = "DONE"
    FAILED = "FAILED"


_LEGAL = {
    RequestState.QUEUED: (RequestState.PREFILL, RequestState.FAILED),
    # PREFILL -> DECODE: one-shot prefill emits the first token at
    # admission; PREFILL -> PREFILLING: the chunked pipeline admits the
    # request and streams its prompt in over subsequent ticks;
    # PREFILL/PREFILLING -> HANDOFF: under disaggregation the prefill
    # worker finishes and parks the request until the decode worker
    # claims it (RAO ticket + wire handoff message)
    RequestState.PREFILL: (RequestState.PREFILLING, RequestState.HANDOFF,
                           RequestState.DECODE, RequestState.FAILED),
    RequestState.PREFILLING: (RequestState.HANDOFF, RequestState.DECODE,
                              RequestState.FAILED),
    RequestState.HANDOFF: (RequestState.DECODE, RequestState.FAILED),
    RequestState.DECODE: (RequestState.DONE, RequestState.FAILED),
    RequestState.DONE: (),
    RequestState.FAILED: (),
}


@dataclass
class Request:
    """One in-flight generation request (wire-decoded or constructed)."""
    req_id: int
    prompt: List[int]
    max_new: int
    generated: List[int] = field(default_factory=list)
    prefilled: int = 0           # prompt tokens already in the cache (chunked)
    slot: int = -1               # ticket-derived slot hint; bound at admission
    done: bool = False
    state: RequestState = RequestState.QUEUED
    ticket: int = -1
    decode_ticket: int = -1      # disagg: decode-worker FAA ticket
    arrival_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0
    done_t: float = 0.0
    wire_bytes: int = 0

    def to(self, state: RequestState, now: Optional[float] = None):
        if state not in _LEGAL[self.state]:
            raise ValueError(f"illegal transition {self.state.value} -> "
                             f"{state.value} (req {self.req_id})")
        self.state = state
        now = time.perf_counter() if now is None else now
        if state is RequestState.PREFILL:
            self.admit_t = now
        elif state is RequestState.HANDOFF:
            # the prefill worker emitted the first token before handing
            # off — TTFT is anchored here, not at decode-slot binding
            self.first_token_t = now
        elif state is RequestState.DECODE:
            if not self.first_token_t:
                self.first_token_t = now
        elif state in (RequestState.DONE, RequestState.FAILED):
            self.done_t = now
            self.done = True

    @property
    def pos(self) -> int:
        """Tokens resident in the cache for this request."""
        return len(self.prompt) + len(self.generated)

    @property
    def latency_s(self) -> float:
        return self.done_t - self.arrival_t

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.arrival_t


class SlotTable:
    """Fixed decode slots; claims go through the RAO FAA ticket sequencer."""

    def __init__(self, n_slots: int, ticket_engine: Optional[RAOEngine] = None):
        if n_slots < 1:
            raise ValueError("need >= 1 slot")
        self.n = n_slots
        self.ticket = ticket_engine or RAOEngine()
        self.active: Dict[int, Request] = {}
        self.tickets_issued = 0

    def claim_ticket(self, addr: int = 0) -> int:
        """FAA on the shared counter — the CENTRAL RAO pattern.  ``addr``
        selects the counter word: the RAO guarantee is per-address
        serialization (see core.rao), so independent sequencers (e.g. the
        disagg decode worker's slot counter) live at distinct addresses."""
        self.tickets_issued += 1
        return self.ticket.execute(RAORequest("FAA", addr, 1))

    def bind(self, req: Request, *, lo: int = 0,
             hi: Optional[int] = None) -> int:
        """Bind `req` to a free slot in ``[lo, hi)``, preferring its
        ticket-derived hint.  The default range is the whole table; the
        disagg engine partitions it into prefill- and decode-worker
        ranges and binds each side within its own."""
        hi = self.n if hi is None else hi
        span = hi - lo
        if span < 1 or lo < 0 or hi > self.n:
            raise ValueError(f"bad slot range [{lo}, {hi}) of {self.n}")
        hint = lo + (req.slot - lo) % span if req.slot >= 0 else lo
        for probe in range(span):
            s = lo + (hint - lo + probe) % span
            if s not in self.active:
                self.active[s] = req
                req.slot = s
                return s
        raise RuntimeError("no free slot")

    def release(self, slot: int) -> Request:
        return self.active.pop(slot)

    def free_in(self, lo: int, hi: int) -> int:
        """Free slots within ``[lo, hi)`` (a worker's slot range)."""
        return sum(1 for s in range(lo, hi) if s not in self.active)

    @property
    def free(self) -> int:
        return self.n - len(self.active)

    @property
    def occupancy(self) -> float:
        return len(self.active) / self.n


class AdmissionQueue:
    """FIFO queue with a family-aware admission predicate.

    ``continuous=True`` (recurrent-state families): any free slot admits.
    ``continuous=False`` (shared-write-index KV caches): admit only when the
    engine is empty or the candidate's prompt length equals the cache's
    current write index — equal-length waves, so an admission never moves
    the shared index under an in-flight request.
    """

    def __init__(self, *, continuous: bool):
        self.continuous = continuous
        self._q: deque = deque()

    def push(self, req: Request):
        self._q.append(req)

    def admissible(self, req: Request, *, engine_empty: bool,
                   write_index: int) -> bool:
        if self.continuous or engine_empty:
            return True
        return len(req.prompt) == write_index

    def pop_admissible(self, *, engine_empty: bool,
                       write_index: int) -> Optional[Request]:
        """Pop the head request if it can be admitted now (FIFO — no
        reordering, so admission is starvation-free)."""
        if not self._q:
            return None
        if self.admissible(self._q[0], engine_empty=engine_empty,
                           write_index=write_index):
            return self._q.popleft()
        return None

    def __len__(self):
        return len(self._q)

    def __iter__(self):
        return iter(self._q)


# --------------------------------------------------------------------------
# KV-cache block paging
# --------------------------------------------------------------------------
def blocks_for(tokens: int, block_tokens: int) -> int:
    """Blocks covering ``tokens`` tokens (the one blocks-per-tokens formula
    shared by the pager's table geometry and the server's decode bucket;
    ``models.transformer.paged_blocks`` is its model-side counterpart and
    the server asserts the two agree on the arena size)."""
    return -(-tokens // block_tokens)


def _crc32_block(digest: int, block: Tuple[int, ...]) -> int:
    """Chained block digest for the prefix cache: crc32 of one block's
    token ids seeded with the parent block's digest, so ``key_i`` commits
    to the entire prefix up to block ``i``.  Deterministic across
    processes (never builtin ``hash`` — lint R1 / the PYTHONHASHSEED
    retrace bug), and collisions are survivable: every cache entry stores
    its token block verbatim and lookups verify chain and tokens."""
    return zlib.crc32(",".join(map(str, block)).encode(), digest)


@dataclass
class _PrefixEntry:
    """One cached full block of a token prefix.  The entry holds its own
    page reference (the +1 that keeps the page alive after every mapping
    slot has released); ``children`` counts cached extensions, so eviction
    only trims leaves and the cache stays a forest of valid chains."""
    page: int
    tokens: Tuple[int, ...]
    parent: Optional[Tuple[int, int]]
    children: int = 0


def _tree_leaves(tree):
    """Leaves of a nested dict/list/tuple cache, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    elif tree is not None:
        yield tree


def _leaf_footprint(cache, n_slots: int, paged: bool):
    """Split the cache pytree into (per-slot-per-token, per-slot-fixed)
    byte footprints.  With ``paged`` (attention-family caches) the
    (L, B, T, ...) KV stacks grow per token; recurrent-state families
    (``paged=False``) have an O(1) per-slot footprint.  ``cache`` is a
    (possibly nested) dict of torch tensors or numpy arrays."""
    per_token = 0
    fixed = 0
    for leaf in _tree_leaves(cache):
        nd = getattr(leaf, "ndim", 0)
        shape = tuple(getattr(leaf, "shape", ()))
        nbytes = getattr(leaf, "nbytes", 0)
        if paged and nd >= 3 and shape[1] == n_slots and shape[2] > 1:
            per_token += nbytes // (n_slots * shape[2])
        elif nd >= 1 and n_slots in shape[:2]:
            fixed += nbytes // n_slots
    return per_token, fixed


class KVBlockPager:
    """Pages each slot's cache footprint through the coherent pool in
    fixed-size token blocks (vLLM-style paging, but the backing store is
    the paper's tiered HBM/host/CXL pool and the cost model is SimCXL).

    Two modes share the accounting/placement core:

    * accounting-only (``track_table=False``): the dense jax cache tensor
      stays dense; the pager reserves pool pages per block, drives
      first-touch binding, counts migrations/faults, and accumulates the
      projected coherent-access latency of the serving run;
    * block-table mode (``track_table=True``): the pager additionally owns
      a real ``(n_slots, max_blocks)`` page table over a pooled KV arena —
      every allocated block carries a concrete page id from a free list,
      and ``table`` backs the paged decode-attention reads
      (``models.transformer.lm_paged_decode_step``).  Page id ``i`` of the
      arena is block ``i`` of the pool accounting, so the placement story
      (HBM vs coherent host/CXL tiers) covers the real data plane.

    Block-table pages are refcounted: a page's count is the number of slot
    page-table rows mapping it plus one if the prefix cache retains it, and
    the physical page (and its pool allocation) is released only when the
    count hits zero.  With ``prefix_cache=True`` the pager additionally
    keeps a chained-digest map from chunk-aligned token prefixes to page
    ids, so admissions whose prompt extends a cached prefix map the same
    physical pool blocks instead of re-prefilling them — copy-on-write at
    block granularity: only FULL prompt blocks are ever shared, every
    write (tail chunks, decode steps) lands in a private block past the
    shared run, so divergence allocates instead of copying and shared
    bytes are immutable for all coherent readers.  Unreferenced cached
    prefixes are evicted LRU under pool pressure.

    With ``near_frames < n_pages`` the block-table mode becomes a real
    **tiering engine**: logical page ids keep covering the full
    ``n_pages`` pool, but only ``near_frames`` physical frames live in
    the HBM-resident near arena the kernels read — the rest back a far
    (host/CXL) arena.  Every allocated page is resident in exactly one
    tier (``_near_of`` / ``_far_of`` map page -> frame); cold pages are
    demoted to the far tier and promoted back (planned per scheduler
    tick, executed by the server as fused gather/scatter copies between
    the two arenas — ``take_migrations`` hands over the frame-pair
    plan).  Block tables keep absolute page ids throughout; ``to_near``
    translates to near-frame indices at dispatch, so kernels and the
    bit-exactness story are untouched.  Pages any engaged slot's next
    step will touch are pinned (never demotion victims), and fresh
    allocations always land near — they are written immediately.
    """

    def __init__(self, cache, *, n_slots: int, max_len: int,
                 block_tokens: int = 16, paged: bool = True,
                 pool: Optional[CoherentMemoryPool] = None,
                 params_bytes: int = 0,
                 hbm_budget: Optional[int] = None,
                 track_table: bool = False,
                 footprint: Optional[Tuple[int, int]] = None,
                 prefix_cache: bool = False,
                 prefix_hash: Optional[Callable[[int, Tuple[int, ...]],
                                                int]] = None,
                 near_frames: Optional[int] = None,
                 tier_policy: Optional[TierPolicy] = None):
        self.block_tokens = block_tokens
        self.n_slots = n_slots
        self.max_len = max_len
        self.pool = pool or CoherentMemoryPool()
        if "xpu0" not in self.pool.pt.devices:   # the decode accelerator
            self.pool.pt.register_device("xpu0")
        if footprint is not None:                # e.g. computed from a pooled
            self.per_token_bytes, self.fixed_bytes = footprint   # KV arena
        else:
            self.per_token_bytes, self.fixed_bytes = _leaf_footprint(
                cache, n_slots, paged)
        self.block_bytes = max(self.per_token_bytes * block_tokens, 1)
        self.track_table = track_table
        self.max_blocks = blocks_for(max_len, block_tokens)
        self.n_pages = n_slots * self.max_blocks
        if prefix_cache and not track_table:
            raise ValueError("prefix_cache requires block-table mode "
                             "(track_table=True)")
        self.prefix_cache = bool(prefix_cache)
        if near_frames is not None and not track_table:
            raise ValueError("near_frames (KV tiering) requires block-table "
                             "mode (track_table=True)")
        if track_table:
            self.table = np.full((n_slots, self.max_blocks), -1, np.int32)
            # LIFO free list: released pages are reused hottest-first
            self._free_pages = list(range(self.n_pages - 1, -1, -1))
            self._page_ref: Dict[int, int] = {}   # page -> live references
            self._page_va: Dict[int, int] = {}    # page -> pool vaddr
        # --- near/far tier residency (tiering engine) ---
        self.near_frames = self.n_pages if near_frames is None \
            else int(near_frames)
        if track_table and not \
                self.max_blocks <= self.near_frames <= self.n_pages:
            raise ValueError(
                f"near_frames must be in [{self.max_blocks} (one slot's "
                f"max_blocks), {self.n_pages} (pool size)], got "
                f"{self.near_frames}")
        self.tiered = track_table and self.near_frames < self.n_pages
        self.far_frames = self.n_pages - self.near_frames if self.tiered \
            else 0
        self.demotions = 0
        self.promotions = 0
        self.forced_demotions = 0
        self.prefetch_blocks = 0
        self.demand_stall_blocks = 0
        self._tick = 0
        self._tick_migrated = 0
        if self.tiered:
            self.policy = tier_policy or derive_policy(
                max(self.per_token_bytes * block_tokens, 1),
                block_tokens=block_tokens)
            self._near_of = np.full(self.n_pages, -1, np.int32)
            self._far_of = np.full(self.n_pages, -1, np.int32)
            self._free_near = list(range(self.near_frames - 1, -1, -1))
            self._free_far = list(range(self.far_frames - 1, -1, -1))
            self._pinned: set = set()      # pages a next dispatch will touch
            self._touch: Dict[int, int] = {}    # page -> last-touched tick
            self._mig_events: List[Tuple[List[Tuple[int, int]],
                                         List[Tuple[int, int]]]] = []
        else:
            self.policy = tier_policy
        self._blocks: Dict[int, List[int]] = {}     # slot -> [vaddr]
        self._state_va: Dict[int, int] = {}         # slot -> fixed-state vaddr
        # prefix cache: (depth, chained digest) -> entry, LRU-ordered
        self._prefix: "OrderedDict[Tuple[int, int], _PrefixEntry]" = \
            OrderedDict()
        self._prefix_hash = prefix_hash or _crc32_block
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_published = 0
        self.prefix_evicted = 0
        self.projected_ns = 0.0
        self.blocks_allocated = 0
        self.blocks_freed = 0
        # placement plan: does the full serving footprint fit in HBM?
        total_kv = n_slots * (self.fixed_bytes
                              + self.per_token_bytes * max_len)
        classes = [
            TensorClass("params", params_bytes, "every_step_bulk", 0),
            TensorClass("kv_cache", total_kv, "sparse_fine", 1,
                        sharers=n_slots if prefix_cache else 1),
        ]
        budget = hbm_budget if hbm_budget is not None else \
            self.pool.tiers["hbm"].capacity_bytes
        self.plan = plan_placement(classes, hbm_budget=budget)
        self._hint = "auto" if self.plan.assignments.get("kv_cache") == "hbm" \
            else "cold"

    def _n_blocks(self, tokens: int) -> int:
        if self.per_token_bytes == 0:      # recurrent state: O(1) footprint
            return 0
        return max(1, blocks_for(tokens, self.block_tokens))

    def admit(self, slot: int, tokens: int) -> List[int]:
        """Allocate the fixed-state region + the blocks covering a freshly
        prefilled slot.  Returns the page ids backing the slot, in position
        order (block-table mode; empty list otherwise)."""
        assert slot not in self._blocks, f"slot {slot} already paged"
        self._blocks[slot] = []
        self._claim_state(slot)
        return self._grow(slot, self._n_blocks(tokens))

    def admit_cached(self, slot: int, prompt: List[int],
                     tokens: int = 0) -> Tuple[int, List[int]]:
        """Admission with prefix-cache lookup: claim the slot's fixed-state
        region, map the longest cached full-block prefix of ``prompt`` into
        its page-table row (pure refcount increments — no allocation, no
        prefill compute for those tokens), then allocate fresh private
        blocks up to ``tokens``.  Returns ``(cached_tokens, new_page_ids)``;
        shared pages never appear in ``new_page_ids``, so callers scatter
        only the freshly written tail blocks."""
        assert slot not in self._blocks, f"slot {slot} already paged"
        self._blocks[slot] = []
        self._claim_state(slot)
        hit = self._acquire_prefix(slot, prompt) if self.prefix_cache else 0
        new = self._grow(slot, max(self._n_blocks(tokens),
                                   len(self._blocks[slot])))
        if hit:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hit
        return hit, new

    def _claim_state(self, slot: int):
        if self.fixed_bytes:
            va = self.pool.malloc(self.fixed_bytes, name=f"state.s{slot}",
                                  hint=self._hint)
            self._state_va[slot] = va
            _, lat = self.pool.access("xpu0", va, write=True,
                                      value=0)
            self.projected_ns += lat

    def _page_alloc(self, slot: int, idx: int) -> int:
        """Claim a free physical page at refcount 1.  Under pool pressure
        the LRU unreferenced prefix-cache entries are evicted to make room
        (retained prefixes are the only way the arena can run dry, since a
        slot alone never exceeds its ``max_blocks`` share)."""
        if not self._free_pages and self.prefix_cache:
            self._evict_lru(1)
        if not self._free_pages:
            raise MemoryError("KV pool exhausted (no free or evictable "
                              "pages)")
        page = self._free_pages.pop()
        va = self.pool.malloc(self.block_bytes, name=f"kv.s{slot}.b{idx}",
                              hint=self._hint)
        self._page_va[page] = va
        self._page_ref[page] = 1
        self.blocks_allocated += 1
        if self.tiered:
            self._frame_claim(page)
        return page

    def _page_share(self, page: int) -> int:
        """Add one reference to a live page (slot mapping or cache
        retention); returns the shared pool vaddr."""
        va = self._page_va[page]
        self.pool.incref(va)
        self._page_ref[page] += 1
        return va

    def _page_decref(self, page: int):
        """Drop one reference; at zero the page returns to the free list
        and its pool allocation is physically released."""
        self.pool.free(self._page_va[page])
        self._page_ref[page] -= 1
        if self._page_ref[page] == 0:
            del self._page_ref[page]
            del self._page_va[page]
            self._free_pages.append(page)
            self.blocks_freed += 1
            if self.tiered:
                self._frame_release(page)

    def _grow(self, slot: int, upto: int) -> List[int]:
        blocks = self._blocks[slot]
        new_pages: List[int] = []
        while len(blocks) < upto:
            idx = len(blocks)
            if self.track_table:
                if idx >= self.max_blocks:
                    raise MemoryError(
                        f"slot {slot} exceeds {self.max_blocks} blocks "
                        f"({self.max_len} tokens)")
                page = self._page_alloc(slot, idx)
                self.table[slot, idx] = page
                new_pages.append(page)
                va = self._page_va[page]
            else:
                va = self.pool.malloc(self.block_bytes,
                                      name=f"kv.s{slot}.b{idx}",
                                      hint=self._hint)
                self.blocks_allocated += 1
            blocks.append(va)
            # first-touch bind from the device side; score the access
            _, lat = self.pool.access("xpu0", va, write=True,
                                      value=0)
            self.projected_ns += lat
        return new_pages

    def advance(self, slot: int, tokens: int) -> List[int]:
        """Called per decode step: grow the block list when the slot's
        token count crosses a block boundary, and touch the hot region.
        Returns any newly allocated page ids (block-table mode)."""
        new_pages = self._grow(slot, self._n_blocks(tokens))
        blocks = self._blocks[slot]
        va = blocks[-1] if blocks else self._state_va[slot]
        _, lat = self.pool.access("xpu0", va, write=True, value=0)
        self.projected_ns += lat
        return new_pages

    def release_behind(self, slot: int, first_live_pos: int) -> int:
        """Partial release (sliding-window reclamation): free the leading
        blocks of ``slot`` that sit *entirely* before ``first_live_pos`` —
        no position >= first_live_pos is touched.  Block indexing stays
        absolute (position // block_tokens): freed table entries become -1,
        which the paged kernels mask dead, and later blocks keep their
        column.  Query positions only move forward, so a block dead for
        this step's window is dead for every future step.  Idempotent;
        returns the number of blocks freed."""
        blocks = self._blocks.get(slot)
        if not blocks or self.per_token_bytes == 0:
            return 0
        # never free the final block: advance()'s hot-region touch and the
        # trailing write always land there
        n_dead = min(first_live_pos // self.block_tokens, len(blocks) - 1)
        freed = 0
        for i in range(n_dead):
            va = blocks[i]
            if va is None:
                continue                       # already released
            blocks[i] = None
            freed += 1
            if self.track_table:
                # drop only this slot's reference: a page retained by the
                # prefix cache (or mapped by another slot) must survive
                # the window sliding past it here
                self._page_decref(int(self.table[slot, i]))
                self.table[slot, i] = -1
            else:
                self.pool.free(va)
                self.blocks_freed += 1
        return freed

    def release(self, slot: int):
        """Drop every reference ``slot`` holds.  Idempotent: releasing a
        slot that is not admitted is a no-op."""
        blocks = self._blocks.pop(slot, [])
        n = len(blocks)
        if self.track_table:
            if n:
                row = self.table[slot, :n]
                # deref LIFO so pages freed here are reused hottest-first
                # by the next admission
                for i in range(n - 1, -1, -1):
                    if row[i] >= 0:
                        self._page_decref(int(row[i]))
                self.table[slot, :n] = -1
        else:
            for va in blocks:
                if va is None:                 # freed by release_behind
                    continue
                self.pool.free(va)
                self.blocks_freed += 1
        va = self._state_va.pop(slot, None)
        if va is not None:
            self.pool.free(va)

    def handoff(self, src: int, dst: int) -> int:
        """Re-home slot ``src``'s entire KV mapping onto slot ``dst`` — the
        disagg prefill->decode page handoff.  Over the coherent pool this
        is pure metadata: the block-table row, block vaddr list, and
        fixed-state region move to ``dst``'s row while every physical page
        stays put at the same page id, refcount, and tier residency (the
        residency/pin/touch maps are page-keyed, so tiering is untouched
        and prefix-shared pages stay shared).  Zero bytes of KV move —
        that is the CXL.cache story ``niccost.on_kv_handoff`` prices
        against the per-block PCIe DMA re-copy.  Returns the number of
        live blocks handed over (the unit the NIC event bills)."""
        assert self.track_table, "handoff requires block-table mode"
        assert src in self._blocks, f"slot {src} not admitted"
        assert dst not in self._blocks, f"slot {dst} already paged"
        blocks = self._blocks.pop(src)
        self._blocks[dst] = blocks
        if src in self._state_va:
            self._state_va[dst] = self._state_va.pop(src)
        n = len(blocks)
        if n:
            self.table[dst, :n] = self.table[src, :n]
            self.table[src, :n] = -1
        return sum(1 for va in blocks if va is not None)

    # ------------------------------------------------------ prefix cache
    def match_prefix(self, prompt: List[int]) -> int:
        """Longest cached chunk-aligned prefix of ``prompt``, in tokens —
        a pure peek (no refcounts move).  Capped one token short of the
        prompt, so even a fully cached prompt recomputes the tail token
        whose logits produce the first output."""
        if not self.prefix_cache:
            return 0
        bt = self.block_tokens
        limit = min(len(prompt) - 1, self.max_len) // bt
        digest = 0
        prev: Optional[Tuple[int, int]] = None
        hit = 0
        for i in range(limit):
            blk = tuple(prompt[i * bt:(i + 1) * bt])
            digest = self._prefix_hash(digest, blk)
            key = (i, digest)
            e = self._prefix.get(key)
            if e is None or e.tokens != blk or e.parent != prev:
                break
            prev = key
            hit += bt
        return hit

    def _acquire_prefix(self, slot: int, prompt: List[int]) -> int:
        """Map the longest cached verified prefix chain into ``slot``'s
        page-table row; every mapped page gains a reference.  Must run at
        admission, before any private block exists."""
        blocks = self._blocks[slot]
        assert not blocks, "prefix acquisition must happen at admission"
        bt = self.block_tokens
        limit = min(len(prompt) - 1, self.max_len) // bt
        digest = 0
        prev: Optional[Tuple[int, int]] = None
        for i in range(limit):
            blk = tuple(prompt[i * bt:(i + 1) * bt])
            digest = self._prefix_hash(digest, blk)
            key = (i, digest)
            e = self._prefix.get(key)
            if e is None or e.tokens != blk or e.parent != prev:
                break
            self._prefix.move_to_end(key)      # refresh LRU position
            va = self._page_share(e.page)
            self.table[slot, i] = e.page
            blocks.append(va)
            # score the coherent read that replaces a prefill write
            _, lat = self.pool.access("xpu0", va, write=False)
            self.projected_ns += lat
            prev = key
        return len(blocks) * bt

    def publish_prefix(self, slot: int, prompt: List[int]) -> int:
        """Register ``slot``'s fully written prompt blocks in the prefix
        cache so later admissions can map them.  Walks the chain from
        block 0 and stops at the first gap: a partial tail block, a
        window-released (-1) table entry, or a colliding cache key — so
        every published chain is contiguous, verified, and fully resident.
        Each new entry holds its own page reference (cache retention).
        Returns the number of entries added."""
        if not self.prefix_cache:
            return 0
        blocks = self._blocks.get(slot)
        if not blocks:
            return 0
        bt = self.block_tokens
        n_full = min(len(prompt) // bt, len(blocks))
        digest = 0
        prev: Optional[Tuple[int, int]] = None
        added = 0
        for i in range(n_full):
            page = int(self.table[slot, i])
            if page < 0:                   # released behind the window —
                break                      # the publishable chain ends
            blk = tuple(prompt[i * bt:(i + 1) * bt])
            digest = self._prefix_hash(digest, blk)
            key = (i, digest)
            e = self._prefix.get(key)
            if e is not None:
                if e.tokens != blk or e.parent != prev:
                    break                  # a foreign chain owns this key
                prev = key                 # already cached (possibly via
                continue                   # our own acquisition)
            self._page_share(page)         # the cache's own reference
            self._prefix[key] = _PrefixEntry(page, blk, prev)
            if prev is not None:
                self._prefix[prev].children += 1
            prev = key
            added += 1
        self.prefix_published += added
        return added

    def _evict_lru(self, want: int) -> int:
        """Evict up to ``want`` unreferenced prefix-cache entries in LRU
        order.  Only leaves (no cached children) whose page is held solely
        by the cache (refcount exactly 1) are evictable; freeing a leaf
        can expose its parent, so the scan repeats until it stops making
        progress."""
        evicted = 0
        progress = True
        while evicted < want and progress:
            progress = False
            for key in list(self._prefix):     # dict front = LRU
                e = self._prefix[key]
                if e.children or self._page_ref.get(e.page, 0) != 1:
                    continue
                del self._prefix[key]
                if e.parent is not None:
                    self._prefix[e.parent].children -= 1
                self._page_decref(e.page)
                self.prefix_evicted += 1
                evicted += 1
                progress = True
                if evicted >= want:
                    break
        return evicted

    def evict_prefixes(self) -> int:
        """Force-drop every prefix-cache entry (tests / drain / explicit
        cache flush).  Pages still mapped by live slots survive on their
        slot references; only the cache's retention refs are dropped.
        Returns the number of entries removed."""
        dropped = 0
        while self._prefix:
            for key in [k for k, e in self._prefix.items()
                        if e.children == 0]:
                e = self._prefix.pop(key)
                if e.parent is not None:
                    self._prefix[e.parent].children -= 1
                self._page_decref(e.page)
                self.prefix_evicted += 1
                dropped += 1
        return dropped

    def evict_to_watermark(self, free_frac: float) -> int:
        """Proactive LRU eviction until at least ``free_frac`` of the pool
        pages are free (the serve-loop eviction watermark); returns the
        number of entries evicted."""
        if not self.prefix_cache:
            return 0
        target = int(self.n_pages * free_frac)
        evicted = 0
        while len(self._free_pages) < target:
            if not self._evict_lru(1):
                break
            evicted += 1
        return evicted

    # --------------------------------------------------- near/far tiering
    def begin_tick(self, tick: int):
        """Advance the pager's tick clock (page coldness is measured in
        scheduler ticks) and reset the per-tick migration traffic gauge.
        Clears the pin set: pins protect pages between a ``plan_near``
        and the same tick's dispatches — across the boundary no dispatch
        is in flight, so admission may demote last tick's working set
        (the engagement plan re-promotes whatever the new tick needs)."""
        self._tick = tick
        self._tick_migrated = 0
        if self.tiered:
            self._pinned = set()

    def _frame_claim(self, page: int):
        """Give a freshly allocated page a near frame (new pages are
        written by the very next dispatch, so they always start near),
        force-demoting a victim when the near tier is full.  The page is
        pinned until the next engagement plan supersedes the pin set."""
        if not self._free_near:
            victims = self._pick_victims(1, forced=True)
            if not victims:
                raise MemoryError("near tier wedged: every near frame is "
                                  "pinned (allocation outside the engaged "
                                  "budget?)")
            dem: List[Tuple[int, int]] = []
            self._demote_pages(victims, dem)
            self._mig_events.append((dem, []))
        frame = self._free_near.pop()
        self._near_of[page] = frame
        self._pinned.add(page)
        self._touch[page] = self._tick

    def _frame_release(self, page: int):
        """Return a dead page's physical frame to its tier's free list."""
        nf = int(self._near_of[page])
        if nf >= 0:
            self._near_of[page] = -1
            self._free_near.append(nf)
        ff = int(self._far_of[page])
        if ff >= 0:
            self._far_of[page] = -1
            self._free_far.append(ff)
        self._pinned.discard(page)
        self._touch.pop(page, None)

    def _pick_victims(self, want: int, *, forced: bool) -> List[int]:
        """Demotion victims, coldest story first: (1) retained-but-
        unreferenced prefix-cache pages, LRU tail first; (2) unpinned
        near pages untouched for >= policy.demote_after ticks, coldest
        first.  ``forced`` extends (2) past the age threshold (counted as
        forced demotions — the near tier had to make room *now*)."""
        out: List[int] = []
        for e in self._prefix.values():        # dict front = LRU
            if len(out) >= want:
                break
            p = e.page
            if p in self._pinned or self._near_of[p] < 0 or p in out:
                continue
            if self._page_ref.get(p, 0) != 1:
                continue                       # a live slot still maps it
            out.append(p)
        if len(out) >= want:
            return out[:want]
        cands = [int(p) for p in np.nonzero(self._near_of >= 0)[0]
                 if p not in self._pinned and p not in out]
        cands.sort(key=lambda p: (self._touch.get(p, -1), p))
        for p in cands:
            if len(out) >= want:
                break
            age = self._tick - self._touch.get(p, self._tick)
            if age < self.policy.demote_after:
                if not forced:
                    break                      # sorted: the rest are warmer
                self.forced_demotions += 1
            out.append(p)
        return out

    def _demote_pages(self, pages: List[int],
                      dem_pairs: List[Tuple[int, int]]):
        """Move near-resident ``pages`` to far frames, recording the
        (near_src, far_dst) copy pairs for the fused migration kernel."""
        for pg in pages:
            if not self._free_far:
                break
            nf = int(self._near_of[pg])
            ff = self._free_far.pop()
            dem_pairs.append((nf, ff))
            self._near_of[pg] = -1
            self._far_of[pg] = ff
            self._free_near.append(nf)
            self.demotions += 1
            self._tick_migrated += 1
            self.pool.migrate(self._page_va[pg], "cxl")

    def engage(self, wants: List[Tuple[int, int]]) -> List[int]:
        """Greedy near-capacity packing: ``wants`` is (slot, tokens) in
        scheduling-priority order, ``tokens`` the count the slot's next
        dispatch makes resident.  Returns the slots whose union of live
        pages plus to-be-allocated blocks fits the near tier together —
        shared (prefix) pages count once, which is what lets an
        overcommitted engine keep every slot engaged.  Untiered pagers
        engage everything.  The first slot is always taken (its demand is
        bounded by max_blocks <= near_frames), so deferral can never
        starve: un-chosen slots simply dispatch on a later tick."""
        if not self.tiered:
            return [s for s, _ in wants]
        chosen: List[int] = []
        union: set = set()
        new_total = 0
        for slot, tokens in wants:
            row = self.table[slot]
            live = {int(p) for p in row[row >= 0]}
            n_new = max(0, self._n_blocks(tokens)
                        - len(self._blocks.get(slot, ())))
            cand = union | live
            if chosen and len(cand) + new_total + n_new > self.near_frames:
                continue
            union = cand
            new_total += n_new
            chosen.append(slot)
        return chosen

    def plan_near_slots(self, slots: List[int], *,
                        prefetch: bool = False) -> int:
        """Pin + promote every live page of ``slots``'s block-table rows
        (the engaged set's full working set) — see ``plan_near``."""
        if not self.tiered:
            return 0
        pages = set()
        for s in slots:
            row = self.table[s]
            pages.update(int(p) for p in row[row >= 0])
        return self.plan_near(pages, prefetch=prefetch)

    def plan_near(self, pages, *, prefetch: bool = False) -> int:
        """Make every page in ``pages`` near-resident before the next
        dispatch reads it.  Replaces the pin set with ``pages``, touches
        them, demotes victims for any shortfall, and plans the promotion
        copies.  Promotions planned on the tick boundary for the *next*
        tick's engaged set are prefetches; promotions a dispatch had to
        wait for are demand-fetch stalls (the steady-state counter the
        bench asserts stays zero).  ``prefetch=True`` additionally runs
        the proactive cold demoter (watermark + age policy).

        Promotion sources are freed into the far free list *before*
        demotion destinations are drawn from it: the fused kernel is
        gather-first, so a far frame freed by a promotion in the same
        event is a legal demotion destination (the both-tiers-full swap).
        Returns the number of promotions planned."""
        if not self.tiered:
            return 0
        pages = {int(p) for p in pages}
        self._pinned = set(pages)
        for p in pages:
            self._touch[p] = self._tick
        need = sorted(p for p in pages if self._near_of[p] < 0)
        dem_pairs: List[Tuple[int, int]] = []
        pro_pairs: List[Tuple[int, int]] = []
        if need:
            pro_src = {}
            for p in need:
                pro_src[p] = int(self._far_of[p])
                self._far_of[p] = -1
                self._free_far.append(pro_src[p])
            shortfall = len(need) - len(self._free_near)
            if shortfall > 0:
                victims = self._pick_victims(shortfall, forced=True)
                if len(victims) < shortfall:
                    raise MemoryError(
                        "near tier wedged: engaged working set exceeds "
                        "unpinned near frames (engage() not consulted?)")
                self._demote_pages(victims, dem_pairs)
            for p in need:
                frame = self._free_near.pop()
                self._near_of[p] = frame
                pro_pairs.append((pro_src[p], frame))
                self.promotions += 1
                self._tick_migrated += 1
                self.pool.migrate(self._page_va[p], "hbm")
            if prefetch:
                self.prefetch_blocks += len(need)
            else:
                self.demand_stall_blocks += len(need)
        if prefetch:
            self._proactive_demote(dem_pairs)
        if dem_pairs or pro_pairs:
            self._mig_events.append((dem_pairs, pro_pairs))
        return len(pro_pairs)

    def _proactive_demote(self, dem_pairs: List[Tuple[int, int]]):
        """Keep ``policy.near_watermark`` of the near tier free by
        demoting cold (age >= policy.demote_after) unpinned pages, at
        most ``policy.migrate_batch`` per tick — allocation bursts then
        hit free frames instead of forcing synchronous demotions."""
        target = int(self.near_frames * self.policy.near_watermark)
        deficit = target - len(self._free_near)
        want = min(deficit, self.policy.migrate_batch, len(self._free_far))
        if want <= 0:
            return
        self._demote_pages(self._pick_victims(want, forced=False), dem_pairs)

    def take_migrations(self):
        """Hand the pending migration plan to the executor: a list of
        events, each ``(dem_pairs, pro_pairs)`` of (src, dst) frame
        indices for one fused ``kv_migrate`` call.  Events MUST run in
        order and before the next arena-touching dispatch — later events
        may reuse frames earlier events freed."""
        ev, self._mig_events = self._mig_events, []
        return ev

    def to_near(self, ids: np.ndarray) -> np.ndarray:
        """Translate absolute page ids -> near-arena frame indices at
        dispatch (-1 masked entries pass through; kernels route them to
        the trash frame).  Untiered pagers are the identity — page id i
        IS frame i.  Every live id must be near-resident: the engaged
        set was planned near before dispatch."""
        if not self.tiered:
            return ids
        a = np.asarray(ids)
        out = np.where(a >= 0, self._near_of[np.maximum(a, 0)],
                       -1).astype(np.int32)
        assert not (out[a >= 0] < 0).any(), \
            "dispatched page not near-resident (plan_near not run?)"
        return out

    def admit_headroom(self) -> int:
        """Near frames obtainable for a fresh admission without touching
        pinned pages: free frames plus demotable (unpinned, far-frame-
        backed) resident ones.  The admission gate queues a request whose
        prompt blocks exceed this — overcommit admits against near+far
        *capacity*, never against frames the engaged set needs now."""
        if not self.tiered:
            return len(self._free_pages) if self.track_table else self.n_pages
        near_res = self.near_frames - len(self._free_near)
        unpinned = max(0, near_res - len(self._pinned))
        return len(self._free_near) + min(unpinned, len(self._free_far))

    def resident_blocks(self, slot: int) -> int:
        """Blocks currently held by ``slot`` (excludes partially-released
        leading blocks)."""
        return sum(1 for va in self._blocks.get(slot, ()) if va is not None)

    def block_table(self, n_blocks: Optional[int] = None) -> np.ndarray:
        """The live page table, optionally truncated to the first
        ``n_blocks`` columns (decode-bucket slicing)."""
        assert self.track_table, "pager built without track_table"
        if n_blocks is None:
            return self.table
        return self.table[:, :n_blocks]

    @property
    def free_pages(self) -> int:
        return len(self._free_pages) if self.track_table else 0

    def stats(self) -> dict:
        out = {
            "block_tokens": self.block_tokens,
            "block_bytes": self.block_bytes,
            "per_token_bytes": self.per_token_bytes,
            "per_slot_fixed_bytes": self.fixed_bytes,
            "blocks_allocated": self.blocks_allocated,
            "blocks_freed": self.blocks_freed,
            "projected_access_us": self.projected_ns / 1e3,
            "kv_tier": self.plan.assignments.get("kv_cache", "hbm"),
            "pool": self.pool.stats(),
        }
        if self.track_table:
            out["paged"] = {
                "pages_total": self.n_pages,
                "pages_free": self.free_pages,
                "pages_in_use": self.n_pages - self.free_pages,
                "max_blocks_per_slot": self.max_blocks,
            }
        if self.tiered:
            out["tier"] = {
                "near_frames": self.near_frames,
                "far_frames": self.far_frames,
                "near_resident": self.near_frames - len(self._free_near),
                "far_resident": self.far_frames - len(self._free_far),
                "pinned": len(self._pinned),
                "demotions": self.demotions,
                "promotions": self.promotions,
                "forced_demotions": self.forced_demotions,
                "prefetch_blocks": self.prefetch_blocks,
                "demand_stall_blocks": self.demand_stall_blocks,
                "tick_migrated_blocks": self._tick_migrated,
                "policy": self.policy.to_dict(),
            }
        if self.prefix_cache:
            out["prefix"] = {
                "entries": len(self._prefix),
                "hits": self.prefix_hits,
                "hit_tokens": self.prefix_hit_tokens,
                "published": self.prefix_published,
                "evicted": self.prefix_evicted,
                "shared_extra_refs": sum(r - 1 for r in
                                         self._page_ref.values()),
            }
        return out
