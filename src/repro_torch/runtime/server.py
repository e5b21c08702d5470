"""Serving runtime (PyTorch counterpart of ``repro/runtime/server.py``).

``BatchServer`` is the synchronous tick loop of the JAX engine, on the
paged plane (dense, moe and vlm families) with chunked or one-shot
prefill, and on the dense-cache plane (``paged_kv=False`` for those
families; the hybrid and ssm families, which have no paged path, always):

  * requests arrive as wire messages (``core.rpc``) and are billed by the
    SimCXL NIC cost model (``runtime.niccost``);
  * slots are claimed through the RAO fetch-and-add ticket sequencer;
  * the KV cache is a pooled page arena indexed by the host-side
    ``KVBlockPager`` block table;
  * a prompt streams in one bucket-padded chunk per tick
    (``_prefill_step`` -> ``model.paged_prefill_chunk``), or, with
    ``prefill_chunk=0`` (one-shot; what ``auto`` picks for capacity-routed
    MoE), equal-length prompts are admitted in groups of up to
    ``prefill_batch``, each group prefilled in one exact-length forward
    (``model.prefill``) and installed by one page write
    (``model.paged_prefill_write``, ``_admit_group``);
  * DECODE slots advance one token per tick in one batched
    ``model.paged_decode_step`` (``_decode_tick``);
  * sliding-window configs page too: ``KVBlockPager.release_behind`` frees
    the blocks behind the window after each chunk and at each decode tick,
    so a slot's footprint stays O(window);
  * ``prefix_cache=True`` shares the pool pages of a block-aligned cached
    prompt prefix copy-on-write (``KVBlockPager.admit_cached`` /
    ``publish_prefix``): a chunked admission resumes at the hit, a
    one-shot one writes only its tail blocks;
  * KV tiering (``kv_overcommit > 1`` or ``kv_near_blocks``): the arena
    the kernels read is a near (HBM) tier smaller than the logical pool,
    and a second arena on the same device holds the far (CXL) tier's cold
    pages.  Each tick the engine engages the slots whose working sets fit
    the near tier (``_plan_engaged``), lands the pager's migration plan
    with ``model.kv_migrate`` before any dispatch touches the arena
    (``_drain_migrations``), and ships block tables translated to near
    frames (``KVBlockPager.to_near``); the NIC cost model bills each
    migration (``niccost.on_kv_migrate``);
  * dense-cache plane: requests are admitted in equal-prompt-length waves
    (the shared write index ``cur``), each group of up to
    ``prefill_batch`` prefilled in one ``model.prefill`` to ``max_len``
    and spliced into the (slots, max_len) cache; every tick decodes all
    slots in one ``model.decode_step``, and the pager only accounts.  For
    the dense, moe (dropless routing) and vlm families the group's prompts
    pad up to the next rung of a geometric bucket ladder
    (``dense_buckets``, ``valid_len`` carrying the real length); under a
    sliding window the cache is a ring of window rows (``cache["pos"]``)
    and prefill is exact-length;
  * the ssm family (xLSTM), whose cache is per-slot recurrent state with
    no shared write index, admits continuously (``self.continuous``, as
    in JAX): a free slot takes the next request whatever its prompt
    length, its states splice into the nested cache tree, ``max_len``
    caps no request, and the pager accounts an O(1) state a slot.
On a CUDA device the steps run their attention, norms, SSD scans (and,
for the moe family, the expert GEMMs and the gated combine) in the
hand-written kernels of ``kernels.ops``; on the CPU in the plain versions.
Dense-cache decode attention stays plain PyTorch, as JAX computes it
outside any Pallas kernel.

``AsyncBatchServer`` is the asyncio engine on the same tick loop:
``submit_async`` resolves a future per request while ``run_engine``
admits and decodes continuously; ``runtime.loadgen`` drives it with
arrival traces.

``DisaggEngine`` splits the slot table into a prefill worker and a decode
worker over the one shared page arena: a finished prefill claims a decode
slot with an RAO fetch-and-add ticket on its own counter word, crosses as
an RPC wire message carrying its block-table row, and its pages are
re-homed by ``KVBlockPager.handoff`` (no KV bytes move), priced by
``niccost.on_kv_handoff``.  ``AsyncDisaggEngine`` is its asyncio engine.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.core import rpc as wire
from repro_torch.core.pool import CoherentMemoryPool
from repro_torch.device import (
    H100_HBM_STREAM_GBs, device_hbm_bytes, resolve_device,
)
from repro_torch.runtime.niccost import NicCostModel, NullNicCostModel
from repro_torch.runtime.scheduler import (
    AdmissionQueue, KVBlockPager, Request, RequestState, SlotTable,
    blocks_for,
)

REQ_SCHEMA = {1: "int", 2: "bytes", 3: "int", "_subs": {}}
# fields: 1=request_id, 2=prompt tokens (int32 bytes), 3=max_new_tokens
RESP_SCHEMA = {1: "int", 2: "bytes", "_subs": {}}
# fields: 1=request_id, 2=generated tokens (int32 bytes)

# disagg prefill->decode handoff message (DisaggEngine): the per-request
# unit of inter-worker wire traffic.  Int-heavy by construction (ticket +
# repeated block-table page ids) plus 'str' prompt metadata.
HANDOFF_SCHEMA = {1: "int", 2: "int", 3: "int", 4: "int", 5: "int",
                  6: "int", 7: "str", 8: "str", "_subs": {}}
# fields: 1=request_id, 2=decode-slot RAO ticket, 3=prompt tokens,
#         4=max_new, 5=generated tokens so far (repeated), 6=block-table
#         page ids in position order, -1 = window-released (repeated),
#         7=model family, 8=handoff lane tag
# the decode worker's slot-ticket counter lives at its own RAO address:
# the linearization guarantee is per-address (core.rao), so the
# prefill-admission counter (addr 0) and this one serialize independently
DECODE_TICKET_ADDR = 64


def _as_list(v) -> list:
    """Normalize a decoded repeated field (scalar when one element)."""
    return v if isinstance(v, list) else [v]


def encode_request(req_id: int, prompt: List[int], max_new: int) -> bytes:
    return wire.encode({1: req_id,
                        2: np.asarray(prompt, np.int32).tobytes(),
                        3: max_new})


def decode_request(buf: bytes) -> Dict:
    msg = wire.decode(buf, REQ_SCHEMA)
    return {"req_id": msg[1],
            "prompt": np.frombuffer(msg[2], np.int32).tolist(),
            "max_new": msg[3]}


def encode_response(req_id: int, tokens: List[int]) -> bytes:
    return wire.encode({1: req_id,
                        2: np.asarray(tokens, np.int32).tobytes()})


def _prefill_buckets(chunk: int, n_buckets: int):
    """Mask-aware pad targets for the ragged last chunk of a prompt:
    geometric halves of ``chunk`` (ascending), at most ``n_buckets`` of
    them, floor 8 tokens.  Every full chunk uses the largest bucket."""
    if n_buckets < 1:
        raise ValueError(f"prefill_buckets must be >= 1, got {n_buckets}")
    sizes = [chunk]
    while len(sizes) < n_buckets and sizes[-1] // 2 >= 8:
        sizes.append(sizes[-1] // 2)
    return tuple(sorted(sizes))


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _splice_rows_tree(cache, cache1, slots: torch.Tensor, n_slots: int):
    """Write a B=k prefill cache into batch rows ``slots`` of the shared
    cache, in place (``index_copy_``), leaf by leaf through the nested
    tree (the xLSTM cache's per-layer state dicts too), as JAX's
    ``jax.tree.map`` does: stacked (L, B, ...) leaves on axis 1,
    per-batch (B, ...) leaves on axis 0, cast to the shared leaf's dtype.
    Scalars and 1-d leaves pass through: the caller owns the shared write
    index and the sliding-window ring's (T,) positions, which no slot
    count may be mistaken for a batch dim of."""
    k = slots.shape[0]
    for name, full in cache.items():
        one = cache1[name]
        if isinstance(full, dict):
            _splice_rows_tree(full, one, slots, n_slots)
            continue
        if one.dim() < 2:
            continue
        if one.shape[1] == k and full.shape[1] == n_slots:
            full.index_copy_(1, slots, one.to(full.dtype))
        elif one.shape[0] == k and full.shape[0] == n_slots:
            full.index_copy_(0, slots, one.to(full.dtype))
    return cache


def _tree_device(tree) -> Optional[torch.device]:
    if isinstance(tree, dict):
        for v in tree.values():
            d = _tree_device(v)
            if d is not None:
                return d
        return None
    return tree.device


class BatchServer:
    """Slot-based batching: on the paged KV plane chunked bucketed or
    one-shot grouped prefill plus batched paged decode; on the dense-cache
    plane (``paged_kv=False``, and what ``auto`` resolves to for a model
    without a paged path) equal-length admission waves (continuous
    admission for the ssm family's recurrent states), grouped (bucketed)
    prefill spliced into the dense cache, and batched decode of every
    slot.

    Per-request lifecycle is the scheduler state machine; slot claims go
    through the RAO ticket sequencer; the pager owns the block table of
    the pooled arena (paged) or accounts the dense cache's blocks in the
    coherent pool (dense).  ``nic_cost=None`` disables the SimCXL NIC
    projection.  ``device`` defaults to the CUDA card; ``params`` must
    live on it (``model.init`` draws them there when omitted).
    """

    def __init__(self, model, *, batch_slots: int = 4, max_len: int = 128,
                 params=None, generator: Optional[torch.Generator] = None,
                 device=None, block_tokens: int = 16,
                 nic_cost: Optional[object] = True,
                 pool: Optional[CoherentMemoryPool] = None,
                 prefill_batch: int = 1,
                 paged_kv="auto", prefill_chunk="auto",
                 prefill_buckets: int = 4, sync_timers: bool = False,
                 prefix_cache: bool = False, prefix_watermark: float = 0.0,
                 kv_overcommit: float = 1.0,
                 kv_near_blocks: Optional[int] = None,
                 kv_demote_after: Optional[int] = None):
        cfg = model.cfg
        has_paged = model.paged_decode_step is not None
        if paged_kv in ("auto", None):
            paged_kv = has_paged
        if paged_kv and not has_paged:
            raise ValueError(f"paged_kv requested but model {cfg.family!r} "
                             f"has no paged decode path")
        self.paged = bool(paged_kv)
        # recurrent-state families admit continuously; shared-write-index
        # KV caches admit in equal-prompt-length waves (scheduler.py),
        # unless the paged plane (per-slot lengths) is active
        self.continuous = cfg.family == "ssm"
        # prefill is chunk/pad-invariant iff routing decisions are a pure
        # per-token function: every family except capacity-factor MoE,
        # whose expert drops depend on the token population of each
        # dispatch call.  Dropless MoE (the serving default of
        # launch.serve) runs the chunked bucketed pipeline like the rest.
        chunk_invariant = cfg.family != "moe" or \
            cfg.moe_routing == "dropless"
        # paged sliding-window attention: release_behind frees the blocks
        # behind the window as it advances; the dense plane keeps a ring
        self.window = int(cfg.sliding_window or 0)
        dense_bucketed = False
        if not self.paged:
            if prefill_chunk not in ("auto", None, 0):
                raise ValueError("prefill_chunk requires the paged KV plane "
                                 "(paged_kv)")
            # dense-plane bucketed one-shot prefill: under "auto", prompt
            # lengths pad up through a geometric bucket table (valid_len
            # carries the real length).  Right-padding is exact only for
            # causal full-attention KV families with pad-invariant
            # routing; explicit prefill_chunk=0 keeps exact-length prefill
            dense_bucketed = (prefill_chunk in ("auto", None)
                              and chunk_invariant and not self.window
                              and cfg.family in ("dense", "moe", "vlm"))
            prefill_chunk = 0
        elif prefill_chunk in ("auto", None):
            prefill_chunk = min(64, max_len) if chunk_invariant else 0
        prefill_chunk = int(prefill_chunk)
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 (0 = one-shot "
                             f"exact-length prefill), got {prefill_chunk}")
        if prefill_chunk and not chunk_invariant:
            raise ValueError(
                "chunked prefill needs chunk-invariant routing: "
                "capacity-factor MoE drops depend on co-resident "
                "tokens; serve with cfg.moe_routing='dropless' or "
                "use prefill_chunk=0")
        self.prefill_chunk = prefill_chunk
        self.chunk_buckets = _prefill_buckets(prefill_chunk, prefill_buckets) \
            if prefill_chunk else ()
        self.dense_buckets = ()
        if dense_bucketed:
            if prefill_buckets < 1:
                raise ValueError(f"prefill_buckets must be >= 1, got "
                                 f"{prefill_buckets}")
            # the dense table runs the full geometric ladder from max_len
            # down to the 8-token floor (not just prefill_buckets rungs):
            # its rungs must reach max_len to cover long prompts, and the
            # ladder keeps padding <= 2x (+ the floor)
            self.dense_buckets = _prefill_buckets(
                max_len, max(prefill_buckets, max_len.bit_length()))
        # -------------------------------------------------- KV tiering
        # kv_overcommit > 1 (or an explicit kv_near_blocks) splits the
        # pooled arena into a near (HBM) tier the kernels read and a far
        # (CXL) tier holding cold pages; logical capacity is unchanged —
        # every page keeps a home — but only near_frames of them are
        # kernel-addressable at once (KVBlockPager does the tiering)
        self.kv_overcommit = float(kv_overcommit)
        if self.kv_overcommit < 1.0:
            raise ValueError(f"kv_overcommit must be >= 1.0 (1.0 = no "
                             f"overcommit), got {kv_overcommit}")
        if kv_near_blocks is not None and self.kv_overcommit != 1.0:
            raise ValueError("kv_near_blocks and kv_overcommit both size "
                             "the near tier; pass one")
        n_pages = batch_slots * blocks_for(max_len, block_tokens)
        near_frames: Optional[int] = None
        if kv_near_blocks is not None:
            near_frames = int(kv_near_blocks)
        elif self.kv_overcommit > 1.0:
            near_frames = max(blocks_for(max_len, block_tokens),
                              int(math.ceil(n_pages / self.kv_overcommit)))
        if near_frames is not None and not self.paged:
            raise ValueError("KV tiering (kv_overcommit/kv_near_blocks) "
                             "requires the paged KV plane (paged_kv)")
        tiered = near_frames is not None and near_frames < n_pages
        if kv_demote_after is not None:
            if int(kv_demote_after) < 1:
                raise ValueError(f"kv_demote_after must be >= 1, got "
                                 f"{kv_demote_after}")
            if not tiered:
                raise ValueError("kv_demote_after requires active KV "
                                 "tiering (kv_overcommit > 1 or "
                                 "kv_near_blocks < pool size)")
        # prefix caching shares KV pool pages across requests whose
        # prompts extend a block-aligned cached prefix; off by default —
        # retained prefixes keep pool pages referenced past request drain
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires the paged KV plane "
                             "(paged_kv)")
        if not 0.0 <= prefix_watermark < 1.0:
            raise ValueError(f"prefix_watermark must be in [0, 1), got "
                             f"{prefix_watermark}")
        self.prefix_cache = bool(prefix_cache)
        self.prefix_watermark = float(prefix_watermark)

        self.model = model
        self.device = resolve_device(device)
        self.max_len = max_len
        self.slots = batch_slots
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = model.init(generator, self.device)
        pdev = _tree_device(params)
        if pdev is not None and pdev != self.device:
            raise ValueError(f"params live on {pdev}, the engine on "
                             f"{self.device}")
        self.params = params
        self.family = cfg.family
        self.prefill_batch = max(1, prefill_batch)
        self.far_pages = None
        if self.paged:
            # tiered: the near arena (what the kernels address, plus its
            # trash frame) and the far arena (the remaining frames), both
            # on the engine's device, as in JAX
            self.pages = model.init_paged_cache(
                batch_slots, max_len, block_tokens, device=self.device,
                frames=near_frames if tiered else None)
            if tiered:
                self.far_pages = model.init_paged_cache(
                    batch_slots, max_len, block_tokens, device=self.device,
                    frames=n_pages - near_frames)
            self.cache = None
            kp = self.pages["kp"]
            # k+v bytes per token, derived from the arena itself
            footprint = (2 * kp.numel() * kp.element_size()
                         // (kp.shape[1] * block_tokens), 0)
        else:
            self.pages = None
            self.cache = model.init_cache(batch_slots, max_len,
                                          device=self.device)
            # the reference's accounting walks the cache tree: the ssm and
            # conv leaves count as per-token bytes, as in JAX
            footprint = None
        # the card's own HBM capacity and stream rate (the pool's defaults
        # are the reference package's and stay for the CPU only)
        hbm = device_hbm_bytes(self.device)
        if pool is None and hbm is not None:
            pool = CoherentMemoryPool(hbm_bytes=hbm)
            pool.tiers["hbm"].stream_bw_GBs = H100_HBM_STREAM_GBs
        self.table = SlotTable(batch_slots)
        self.queue = AdmissionQueue(continuous=self.continuous or self.paged)
        # a continuously admitted family's per-slot states are O(1): the
        # reference's pager counts them as fixed bytes, never per token
        # (``paged=has_kv`` there)
        self.pager = KVBlockPager(self.cache, n_slots=batch_slots,
                                  max_len=max_len, block_tokens=block_tokens,
                                  paged=not self.continuous, pool=pool,
                                  params_bytes=_tree_nbytes(self.params),
                                  hbm_budget=hbm, track_table=self.paged,
                                  footprint=footprint,
                                  prefix_cache=self.prefix_cache,
                                  near_frames=near_frames)
        self.tiered = self.pager.tiered
        if kv_demote_after is not None:
            self.pager.policy = dataclasses.replace(
                self.pager.policy, demote_after=int(kv_demote_after))
        # the model sized the arenas, the pager sized the page table: every
        # near frame index must address a real (non-trash) arena page, and
        # near + far frames must cover the logical pool
        if self.paged:
            assert self.pages["kp"].shape[1] == self.pager.near_frames + 1, \
                (tuple(self.pages["kp"].shape), self.pager.near_frames)
            if self.tiered:
                assert self.far_pages["kp"].shape[1] == \
                    self.pager.far_frames + 1, \
                    (tuple(self.far_pages["kp"].shape),
                     self.pager.far_frames)
        if nic_cost is True:
            self.niccost = NicCostModel()
        elif nic_cost in (None, False):
            self.niccost = NullNicCostModel()
        else:
            self.niccost = nic_cost
        # PyTorch runs eagerly: the engine's step functions are the model's
        # plain callables (jit_fns() lists them under the JAX names)
        self._prefill_exact = model.prefill
        self._prefill = lambda p, t: model.prefill(p, t, max_len)
        # bucket-padded one-shot prefill of the dense plane: tokens padded
        # to a bucket length, valid_len carries the real prompt length
        self._prefill_bucketed = lambda p, t, vl: model.prefill(p, t,
                                                                max_len, vl)
        self._decode = model.decode_step
        self._page_write = model.paged_prefill_write
        self._chunk_prefill = model.paged_prefill_chunk
        self._paged_decode = model.paged_decode_step
        # fused demote/promote copy between the arenas, in place
        # (gather-first inside, so one event can swap through a full tier)
        self._kv_migrate = model.kv_migrate
        # engagement bookkeeping (tiered plane): which slots this tick's
        # dispatches may touch, and a least-recently-engaged clock so
        # deferral rotates fairly.  None = everything engaged (untiered).
        self._engaged: Optional[Set[int]] = None
        self._last_engaged: Dict[int, int] = {}
        # quiet-tick fast path: mid-wave steady ticks (no admission,
        # release, or migration since the last full plan, and no slot
        # crossing a block boundary) cannot allocate frames or touch a
        # far page, so the whole engage/plan/pin cycle is skipped
        self._tier_dirty = True
        self._engaged_cache: Optional[Set[int]] = None
        # block after each dispatch so the wall-clock stats attribute the
        # device time honestly (benchmarks); off by default
        self.sync_timers = sync_timers
        self.stats = {"prefills": 0, "prefill_chunks": 0, "decode_steps": 0,
                      "completed": 0, "failed": 0, "admitted": 0, "ticks": 0,
                      "decode_tokens": 0, "decode_wall_s": 0.0,
                      "admit_wall_s": 0.0, "splice_wall_s": 0.0}
        self.completed_reqs: List[Request] = []
        self._unbilled_tickets = 0
        self._busy_slot_ticks = 0
        self._closed = False

    # ---------------------------------------------------------- properties
    @property
    def active(self) -> Dict[int, Request]:
        return self.table.active

    @property
    def slot_utilization(self) -> float:
        total = self.stats["ticks"] * self.slots
        return self._busy_slot_ticks / total if total else 0.0

    def jit_fns(self) -> Dict[str, Callable]:
        """Name -> engine step callable (the JAX engine's jit registry
        names; here plain eager functions)."""
        if not self.paged:
            fns = {"prefill": self._prefill, "decode": self._decode,
                   "splice": _splice_rows_tree}
            if self.dense_buckets:
                fns["prefill_bucketed"] = self._prefill_bucketed
            return fns
        fns = {"prefill_exact": self._prefill_exact,
               "paged_decode": self._paged_decode,
               "page_write": self._page_write}
        if self.prefill_chunk:
            fns["chunk_prefill"] = self._chunk_prefill
        if self.tiered:
            fns["kv_migrate"] = self._kv_migrate
        return fns

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- admit
    def _request_from_msg(self, msg: Dict, wire_len: int) -> Request:
        req = Request(msg[1], np.frombuffer(msg[2], np.int32).tolist(),
                      msg[3])
        req.wire_bytes = wire_len
        return req

    def submit_wire(self, buf: bytes):
        msg = wire.decode(buf, REQ_SCHEMA)     # single decode on ingress
        self.niccost.on_ingress(msg)
        self.submit(self._request_from_msg(msg, len(buf)))

    def submit(self, req: Request):
        if self._closed:
            raise RuntimeError("server closed to new submissions")
        # decentralized slot claim: FAA ticket mod slots (binding to a
        # concrete free slot happens at admission time)
        req.ticket = self.table.claim_ticket()
        req.slot = self._ticket_hint(req.ticket)
        self._unbilled_tickets += 1
        if req.arrival_t == 0.0:
            req.arrival_t = time.perf_counter()
        self.queue.push(req)

    def close(self):
        """No further submissions; drain what is queued."""
        self._closed = True

    def reopen(self):
        """Accept submissions again after a drain."""
        self._closed = False

    # ------------------------------------------------------ worker hooks
    # The monolithic engine owns the whole slot table and moves finished
    # prefills straight into DECODE.  DisaggEngine overrides these to
    # partition the table into a prefill-worker range and a decode-worker
    # range and to route finished prefills through the wire handoff.
    def _ticket_hint(self, ticket: int) -> int:
        """Slot hint derived from the admission FAA ticket."""
        return ticket % self.slots

    def _bind_admit(self, req: Request) -> int:
        """Bind an admitted request to a slot (the prefill worker's range
        under disaggregation)."""
        return self.table.bind(req)

    def _admit_free(self) -> int:
        """Slots the admission loop may still fill this tick."""
        return self.table.free

    def _after_prefill(self, req: Request, now: float):
        """A request's prompt is fully resident and its first token is
        emitted: the monolith decodes it in place; disagg parks it for
        the decode-worker handoff."""
        req.to(RequestState.DECODE, now)

    def _do_handoffs(self, now: float):
        """Monolith: no handoff stage."""

    def _fail(self, req: Request, now: float) -> bytes:
        req.to(RequestState.FAILED, now)
        self.stats["failed"] += 1
        self.completed_reqs.append(req)
        buf = encode_response(req.req_id, [])
        self._notify(req, buf)
        return buf

    def _admit_group(self, reqs: List[Request], now: float):
        """Prefill a group of equal-prompt-length requests in one call
        (B = len(reqs)), then install it: on the paged plane one page
        write that touches only the admitted slots' pages, on the dense
        plane one in-place splice of the slots' cache rows and the shared
        write index (and ring positions).  The dense plane's bucketed
        prefill pads the prompts up to the first bucket that holds them."""
        for req in reqs:
            req.to(RequestState.PREFILL, now)
        slot_arr = [self._bind_admit(req) for req in reqs]
        toks = np.asarray([r.prompt for r in reqs], np.int32)
        S = int(toks.shape[1])
        bucket = next((b for b in self.dense_buckets if b >= S), None)
        if bucket is not None:
            padded = np.pad(toks, ((0, 0), (0, bucket - S)))
            logits, cache1 = self._prefill_bucketed(
                self.params, self._to_device(padded), S)
        else:
            prefill = self._prefill_exact if self.paged else self._prefill
            logits, cache1 = prefill(self.params, self._to_device(toks))
        # only the (G,) greedy ids leave the device
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        t1 = time.perf_counter()
        for row, req in enumerate(reqs):
            req.generated.append(int(nxt[row]))
            self._after_prefill(req, t1)

        tw = time.perf_counter()
        if self.paged:
            # ring-packed sliding-window rows (S > window) leave zero KV in
            # their leading positions: those pages must be neither
            # acquired from nor published into the prefix cache
            shareable = not (self.window and S > self.window)
            skip = 0
            if self.prefix_cache and len(reqs) == 1 and shareable:
                # map the shared prefix pages (refcounts, no allocation)
                # and write ONLY the tail blocks: shared pages are
                # immutable for their co-resident readers
                skip, ids = self.pager.admit_cached(slot_arr[0],
                                                    reqs[0].prompt, S)
                if skip:
                    self.niccost.on_prefix_share(
                        skip // self.pager.block_tokens,
                        self.pager.block_bytes)
            else:
                ids = [p for slot in slot_arr
                       for p in self.pager.admit(slot, S)]
            # fresh allocations may have force-demoted cold pages: land
            # those copies before the write; the new pages are near by
            # construction, so the id -> near-frame translation is total
            self._drain_migrations()
            ids_near = self.pager.to_near(np.asarray(ids, np.int32))
            self.pages = self._page_write(
                self.pages, cache1["k"], cache1["v"],
                self._to_device(ids_near), S, skip)
            if self.prefix_cache and shareable:
                for slot, req in zip(slot_arr, reqs):
                    self.pager.publish_prefix(slot, req.prompt)
        else:
            self.cache = _splice_rows_tree(
                self.cache, cache1, self._to_device(
                    np.asarray(slot_arr, np.int64)), self.slots)
            if not self.continuous:
                # shared write index: admission waves have equal prompt
                # lengths, so overwriting it never moves it under an
                # in-flight request
                self.cache["cur"] = cache1["cur"]
            if "pos" in self.cache:
                # the shared sliding-window ring positions: every in-flight
                # slot sits at the same cur, and the freshly prefilled ring
                # is the canonical pos state there (left all -1, decode
                # would mask the whole prompt dead)
                self.cache["pos"] = cache1["pos"]
            for slot in slot_arr:
                self.pager.admit(slot, self.table.active[slot].pos)
        if self.sync_timers:
            self._sync()
        self.stats["splice_wall_s"] += time.perf_counter() - tw
        self.stats["prefills"] += len(reqs)
        self.stats["admitted"] += len(reqs)
        self._tier_dirty = True                # fresh slots + page claims

    def _admit(self, now: float) -> List[bytes]:
        """Admit from the queue while slots are free.  Chunked: each
        admission binds a slot and streams its prompt in later ticks.
        One-shot: consecutive requests with the same prompt length
        prefill as one batched call (up to ``prefill_batch``)."""
        failures: List[bytes] = []
        group: List[Request] = []
        # overcommit admission gate: a request only enters a slot when its
        # prompt blocks fit the obtainable near frames (free + demotable);
        # otherwise it stays queued.  Chunked admissions allocate one
        # block up front and stream the rest under the engagement plan,
        # so they gate on a single block.
        headroom = self.pager.admit_headroom() if self.tiered else None
        planned = 0

        def flush():
            if group:
                self._admit_group(group, now)
                group.clear()

        while self._admit_free() > len(group):
            if self.tiered:
                head = next(iter(self.queue), None)
                if head is not None:
                    need = 1 if self.prefill_chunk else max(
                        1, blocks_for(min(len(head.prompt), self.max_len),
                                      self.pager.block_tokens))
                    if planned + need > headroom:
                        break
                    planned += need
            empty = not self.active and not group
            if self.continuous or self.paged or empty:
                wi = 0                            # unused by the policy
            elif group:
                # mid-wave: the group fixes the admissible prompt length
                wi = len(group[0].prompt)
            else:
                wi = int(self.cache["cur"])       # device sync only if needed
            req = self.queue.pop_admissible(engine_empty=empty,
                                            write_index=wi)
            if req is None:
                break
            if not req.prompt or req.max_new < 1 or \
                    (self.paged and len(req.prompt) > self.max_len):
                failures.append(self._fail(req, now))
                continue
            if self.prefill_chunk:
                self._admit_chunked(req, now)
                continue
            if self.prefix_cache and self.pager.match_prefix(req.prompt):
                # cached-prefix one-shot admissions go as singleton
                # groups: the page write's skip count is one per group
                flush()
                group.append(req)
                flush()
                continue
            if group and (len(group) >= self.prefill_batch
                          or len(req.prompt) != len(group[0].prompt)):
                flush()
            group.append(req)
        flush()
        return failures

    def _admit_chunked(self, req: Request, now: float):
        """Chunked admission: claim the slot and the fixed-state region;
        prompt pages are allocated chunk by chunk, and the first token
        comes out of the final chunk."""
        req.to(RequestState.PREFILL, now)
        self._bind_admit(req)
        if self.prefix_cache:
            hit, _ = self.pager.admit_cached(req.slot, req.prompt, 0)
            if hit:
                # resume mid-prompt: positions [0, hit) are already
                # resident in shared pages
                req.prefilled = hit
                self.niccost.on_prefix_share(
                    hit // self.pager.block_tokens, self.pager.block_bytes)
        else:
            self.pager.admit(req.slot, 0)
        req.to(RequestState.PREFILLING, now)
        self.stats["admitted"] += 1

    # ------------------------------------------------------------ decode
    def _finish(self, req: Request, now: float) -> bytes:
        req.to(RequestState.DONE, now)
        slot = req.slot
        self.table.release(slot)
        self.pager.release(slot)
        self.stats["completed"] += 1
        self.completed_reqs.append(req)
        buf = encode_response(req.req_id, req.generated)
        self.niccost.on_egress({1: req.req_id,
                                2: np.asarray(req.generated,
                                              np.int32).tobytes()})
        self._notify(req, buf)
        return buf

    def _exhausted(self, req: Request) -> bool:
        # continuously admitted (recurrent-state, xLSTM) families hold an
        # O(1) state a slot: no max_len caps them, as in JAX
        return len(req.generated) >= req.max_new or \
            (not self.continuous and req.pos >= self.max_len)

    def _harvest(self, now: float) -> List[bytes]:
        out = [self._finish(req, now)
               for _, req in sorted(self.active.items())
               if req.state is RequestState.DECODE
               and self._exhausted(req)]
        if out:
            self._tier_dirty = True            # slots released pages
        return out

    # ----------------------------------------------------- chunked prefill
    def _prefill_step(self):
        """Advance every PREFILLING slot by one prompt chunk (ragged last
        chunks pad up into ``chunk_buckets``), batched over the full slot
        dimension with the full-width block table."""
        pre = {slot: req for slot, req in self.active.items()
               if req.state is RequestState.PREFILLING}
        if self._engaged is not None:
            # tiered plane: only the engaged slots' pages are near; the
            # deferred ones chunk on a later tick (engage() rotates)
            pre = {s: r for s, r in pre.items() if s in self._engaged}
        if not pre:
            return
        step_v: Dict[int, int] = {}
        hi = 0
        for slot, req in pre.items():
            v = min(self.prefill_chunk, len(req.prompt) - req.prefilled)
            step_v[slot] = v
            hi = max(hi, v)
        C = next(b for b in self.chunk_buckets if b >= hi)
        toks = np.zeros((self.slots, C), np.int32)
        ctx = np.zeros((self.slots,), np.int32)
        valid = np.zeros((self.slots,), np.int32)
        for slot, req in pre.items():
            v = step_v[slot]
            toks[slot, :v] = req.prompt[req.prefilled:req.prefilled + v]
            ctx[slot] = req.prefilled
            valid[slot] = v
            self.pager.advance(slot, req.prefilled + v)
        # chunk growth may have force-demoted; land copies pre-dispatch
        self._drain_migrations()
        btab = self.pager.to_near(self._masked_block_table(pre))
        completes = any(req.prefilled + step_v[slot] >= len(req.prompt)
                        for slot, req in pre.items())
        t0 = time.perf_counter()
        logits, self.pages = self._chunk_prefill(
            self.params, self.pages, self._to_device(toks),
            self._to_device(btab), self._to_device(ctx),
            self._to_device(valid))
        # greedy ids leave the device only on ticks where a prompt
        # completes (mid-prompt logits are never read), and only the (B,)
        # argmax, not the logits
        nxt = torch.argmax(logits, dim=-1).cpu().numpy() if completes \
            else None
        if self.sync_timers:
            self._sync()
        self.stats["splice_wall_s"] += time.perf_counter() - t0
        self.stats["prefill_chunks"] += 1
        now = time.perf_counter()
        for slot, req in pre.items():
            req.prefilled += step_v[slot]
            if self.window:
                # the next query position is >= req.prefilled: everything
                # behind its window is dead for every future step
                self.pager.release_behind(
                    slot, max(0, req.prefilled - self.window + 1))
            if req.prefilled >= len(req.prompt):
                req.generated.append(int(nxt[slot]))
                self._after_prefill(req, now)
                self.stats["prefills"] += 1
                if self.prefix_cache:
                    # chunk writes are position-exact, so the complete
                    # prompt blocks are publishable; window-released
                    # leading blocks (-1 entries) end the chain
                    self.pager.publish_prefix(slot, req.prompt)

    def _masked_block_table(self, live, nb: Optional[int] = None):
        """Owned copy of the pager's block table with the rows of every
        slot NOT in ``live`` set to -1: the kernels mask those reads dead
        and route their writes to the trash page, so a dispatch can never
        touch a slot it doesn't own."""
        btab = np.array(self.pager.block_table(nb))
        skip = np.ones((self.slots,), bool)
        skip[list(live)] = False
        btab[skip] = -1
        return btab

    def _decode_bucket(self, max_resident: int) -> int:
        """Block-table columns to ship this step: blocks covering every
        resident token plus the incoming one, rounded up to a multiple of
        8 (short contexts never pay attention over the engine's max_len;
        the kernel reads the width at run time)."""
        need = max(1, blocks_for(max_resident, self.pager.block_tokens))
        return min(self.pager.max_blocks, -(-need // 8) * 8)

    # ------------------------------------------------------- KV tiering
    @staticmethod
    def _pad_pairs(pairs, trash_src: int, trash_dst: int, m: int):
        """(src, dst) frame pairs -> int32 index arrays padded to width
        ``m`` with trash-to-trash self-copies (the trash frames are
        never read meaningfully, so extra copies are inert)."""
        src = np.full((m,), trash_src, np.int32)
        dst = np.full((m,), trash_dst, np.int32)
        for i, (s, d) in enumerate(pairs):
            src[i] = s
            dst[i] = d
        return src, dst

    def _drain_migrations(self):
        """Execute the pager's pending migration plan against the arenas.
        Events run in plan order (later events may reuse frames earlier
        ones freed) and all land before the next arena-touching dispatch:
        the copies are queued on the device's stream ahead of it."""
        if not self.tiered:
            return
        for dem, pro in self.pager.take_migrations():
            # both sides padded to one power-of-two width, as in JAX (its
            # compiled shape family; here only the trash copies follow)
            m = 1 << (max(1, len(dem), len(pro)) - 1).bit_length()
            ds, dd = self._pad_pairs(dem, self.pager.near_frames,
                                     self.pager.far_frames, m)
            ps, pd = self._pad_pairs(pro, self.pager.far_frames,
                                     self.pager.near_frames, m)
            self.pages, self.far_pages = self._kv_migrate(
                self.pages, self.far_pages, self._to_device(ds),
                self._to_device(dd), self._to_device(ps),
                self._to_device(pd))
            if dem or pro:
                self.niccost.on_kv_migrate(len(dem) + len(pro),
                                           self.pager.block_bytes)
                self._tier_dirty = True        # residency moved

    def warmup_migrations(self):
        """The JAX engine compiles every migrate shape here, off the
        serving path; eager PyTorch has nothing to compile, so this runs
        the same inert trash-to-trash self-copies at each power-of-two
        width (callers and the engine's call sequence match JAX's)."""
        if not self.tiered:
            return
        nt, ft = self.pager.near_frames, self.pager.far_frames
        m, bound = 1, max(nt, ft)
        while True:
            near_trash = self._to_device(np.full((m,), nt, np.int32))
            far_trash = self._to_device(np.full((m,), ft, np.int32))
            self.pages, self.far_pages = self._kv_migrate(
                self.pages, self.far_pages, near_trash, far_trash,
                far_trash, near_trash)
            if m >= bound:
                break
            m <<= 1
        self._sync()

    def _want_tokens(self, req: Request) -> int:
        """Tokens the slot's next dispatch makes resident (the engagement
        demand unit)."""
        if req.state is RequestState.PREFILLING:
            # +1: a chunk that completes the prompt decodes this same
            # tick at position len(prompt) + 1
            t = min(req.prefilled + self.prefill_chunk,
                    len(req.prompt)) + 1
        else:
            t = req.pos
        return min(t, self.max_len)

    def _quiet_tick(self) -> bool:
        """True when this tick provably needs no engagement plan: nothing
        was admitted, released, or migrated since the last full plan, the
        cached engaged set covers every active slot, and no slot's next
        dispatch crosses a block boundary.  Under those conditions no
        frame can be claimed and no far page read, so skipping the plan
        (including its pins — pins only guard claims) is sound.  Sliding-
        window engines are excluded: release-behind changes block lists
        mid-tick."""
        if self._tier_dirty or self.window or self._engaged_cache is None:
            return False
        bt = self.pager.block_tokens
        for slot, req in self.active.items():
            if slot not in self._engaged_cache:
                return False                   # a deferred slot wants in
            if req.state not in (RequestState.PREFILLING,
                                 RequestState.DECODE):
                return False
            if blocks_for(self._want_tokens(req), bt) \
                    > self.pager.resident_blocks(slot):
                return False
        return True

    def _plan_engaged(self, *, prefetch: bool = False) -> Optional[Set[int]]:
        """Pick the slots this tick's dispatches may touch (near-capacity
        packing over their working sets, least-recently-engaged first so
        deferral rotates) and make their pages near-resident.  With
        ``prefetch=True`` (end of tick) the same plan runs for the *next*
        tick's set, so its promotions count as prefetches, not demand
        stalls."""
        if not self.tiered:
            return None
        if self._quiet_tick():
            return self._engaged_cache
        wants = []
        order = sorted(self.active.items(),
                       key=lambda kv: (self._last_engaged.get(kv[0], -1),
                                       kv[0]))
        for slot, req in order:
            if req.state not in (RequestState.PREFILLING,
                                 RequestState.DECODE):
                continue
            wants.append((slot, self._want_tokens(req)))
        if not wants:
            # still reset pins / run the proactive demoter on idle ticks
            self.pager.plan_near(set(), prefetch=prefetch)
            self._drain_migrations()
            self._engaged_cache = set()
            self._tier_dirty = False
            return set()
        engaged = self.pager.engage(wants)
        self.pager.plan_near_slots(engaged, prefetch=prefetch)
        self._drain_migrations()
        if not prefetch:
            for s in engaged:
                self._last_engaged[s] = self.stats["ticks"]
        # the plan + drained copies leave the engaged set near-resident
        # and consistent: until something changes (dirty), subsequent
        # ticks may reuse it without replanning
        self._engaged_cache = set(engaged)
        self._tier_dirty = False
        return self._engaged_cache

    def step(self) -> List[bytes]:
        """One scheduler tick: admit from queue (one-shot: prefilling each
        admission group), plan the tiered engine's engaged set, advance
        chunked prefills by one chunk, hand finished prefills to the
        decode worker (disagg only), one batched decode step over the
        DECODE slots."""
        now = time.perf_counter()
        self.stats["ticks"] += 1
        if self.tiered:
            # pins protect pages only within a tick; admission may demote
            # last tick's working set (the plan below re-promotes)
            self.pager.begin_tick(self.stats["ticks"])
        if self.prefix_cache and self.prefix_watermark:
            # proactive LRU eviction keeps free-page headroom for
            # incoming admissions
            self.pager.evict_to_watermark(self.prefix_watermark)
        if self._unbilled_tickets:
            self.niccost.on_ticket_batch(self._unbilled_tickets)
            self._unbilled_tickets = 0
        finished = self._admit(now)
        self.stats["admit_wall_s"] += time.perf_counter() - now
        # tiered plane: pick + promote this tick's engaged working set
        # before any dispatch reads the arena (demand fetches land here)
        self._engaged = self._plan_engaged()
        if self.prefill_chunk:
            self._prefill_step()
        # disagg: move HANDOFF-parked requests into decode-worker slots
        # before harvest, so an already-exhausted handoff (max_new == 1)
        # finishes this same tick
        self._do_handoffs(now)
        # prefill emits the first token: single-token requests are already
        # complete and must not burn a decode step
        finished += self._harvest(now)
        return finished + self._decode_tick(now)

    def _decode_tick(self, now: float) -> List[bytes]:
        """One batched decode dispatch over the DECODE slots."""
        self._busy_slot_ticks += len(self.active)
        decoding = {slot: req for slot, req in self.active.items()
                    if req.state is RequestState.DECODE}
        if self._engaged is not None:
            decoding = {s: r for s, r in decoding.items()
                        if s in self._engaged}
        if not decoding:
            if self.tiered:
                # prefetch the next tick's working set into the near tier
                self._plan_engaged(prefetch=True)
            return []
        last = np.zeros((self.slots, 1), np.int32)
        for slot, req in decoding.items():
            last[slot, 0] = req.generated[-1] if req.generated else 0
        # the window starts before the pager's host work, as JAX's does
        t0 = time.perf_counter()
        if self.paged:
            lens = np.zeros((self.slots,), np.int32)
            for slot, req in decoding.items():
                lens[slot] = req.pos - 1          # tokens resident in pages
                # grow the block list so the incoming token's page exists
                # before the kernel computes its write location
                self.pager.advance(slot, req.pos)
                if self.window:
                    # blocks wholly behind this (and every later) query's
                    # window go back to the free list; the decode kernel
                    # reads from lens - window + 1 on, which stays inside
                    # the blocks kept
                    self.pager.release_behind(
                        slot, max(0, req.pos - self.window))
            nb = self._decode_bucket(int(lens.max()) + 1)
            # token-growth allocations may have force-demoted cold pages
            self._drain_migrations()
            # PREFILLING slots hold live table rows but must be neither
            # attended nor written by the decode step
            btab = self.pager.to_near(self._masked_block_table(decoding, nb))
            logits, self.pages = self._paged_decode(
                self.params, self.pages, self._to_device(last),
                self._to_device(btab), self._to_device(lens))
        else:
            # every slot decodes at the shared write index, free ones too
            # (their rows are overwritten wholesale on admission)
            logits, self.cache = self._decode(self.params, self.cache,
                                              self._to_device(last))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.stats["decode_wall_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(decoding)
        now = time.perf_counter()
        for slot, req in decoding.items():
            req.generated.append(int(nxt[slot]))
            if not self.paged:
                self.pager.advance(slot, req.pos)
        finished = self._harvest(now)
        if self.tiered:
            # plan + fetch the next tick's engaged set now: these copies
            # land at the tick boundary and count as prefetches
            self._plan_engaged(prefetch=True)
        return finished

    def run_until_drained(self,
                          max_ticks: Optional[int] = None) -> List[bytes]:
        """Tick until queue and slots are empty (or ``max_ticks``)."""
        out = []
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            ticks += 1
            out.extend(self.step())
            if not len(self.queue) and not self.active:
                break
        return out

    # --------------------------------------------------------- reporting
    def _notify(self, req: Request, buf: bytes):
        """Completion hook (AsyncBatchServer resolves futures here)."""

    def kv_stats(self) -> dict:
        out = self.pager.stats()
        out["paged_kv"] = self.paged
        out["tiered"] = self.tiered
        return out

    def nic_report(self) -> dict:
        return self.niccost.report()


class AsyncBatchServer(BatchServer):
    """Asyncio continuous-batching engine on the same scheduler core.

    ``submit_async`` enqueues a request and resolves to its wire response;
    ``run_engine`` is the engine coroutine — it admits + decodes while work
    is pending and parks on an event when idle.  ``close()`` lets the
    engine exit once everything in flight has drained.  Each ``step``
    already ends in the argmax copy to the host, so the coroutine adds no
    device sync of its own.
    """

    def __init__(self, *args, idle_wait_s: float = 0.01, **kwargs):
        super().__init__(*args, **kwargs)
        self.idle_wait_s = idle_wait_s
        self._futures: Dict[int, asyncio.Future] = {}
        self._wakeup: Optional[asyncio.Event] = None
        self._engine_exc: Optional[BaseException] = None

    def _event(self) -> asyncio.Event:
        if self._wakeup is None:
            self._wakeup = asyncio.Event()
        return self._wakeup

    async def submit_async(self, req) -> bytes:
        """Submit a Request (or wire-encoded bytes); awaits the response."""
        if self._engine_exc is not None:
            raise RuntimeError("engine crashed") from self._engine_exc
        # decode/validate before submitting: if anything raises (closed
        # server, bad wire bytes, duplicate id) no orphaned future is left
        # behind to wedge _drained(), and no future gets overwritten
        if isinstance(req, (bytes, bytearray)):
            buf = bytes(req)
            msg = wire.decode(buf, REQ_SCHEMA)
            rid = msg[1]
            self._check_unique(rid)
            self.niccost.on_ingress(msg)
            self.submit(self._request_from_msg(msg, len(buf)))
        else:
            rid = req.req_id
            self._check_unique(rid)
            self.submit(req)
        fut = asyncio.get_running_loop().create_future()
        self._futures[rid] = fut
        self._event().set()
        return await fut

    def _check_unique(self, rid: int):
        if rid in self._futures:
            raise ValueError(f"request id {rid} already in flight")

    def close(self):
        super().close()
        if self._wakeup is not None:
            self._wakeup.set()

    def reopen(self):
        super().reopen()
        self._wakeup = None     # the next drive loop binds a fresh event

    def _notify(self, req: Request, buf: bytes):
        fut = self._futures.pop(req.req_id, None)
        if fut is not None and not fut.done():
            fut.set_result(buf)

    def _drained(self) -> bool:
        return not len(self.queue) and not self.active and not self._futures

    async def run_engine(self):
        """Engine loop: tick while work is pending, park when idle, exit
        when closed and fully drained.  A crash fails every outstanding
        future so no awaiting submitter hangs."""
        ev = self._event()
        try:
            while not (self._closed and self._drained()):
                if self.active or len(self.queue):
                    self.step()
                    await asyncio.sleep(0)        # cooperative yield
                    continue
                ev.clear()
                if self._closed and self._drained():
                    break
                try:
                    await asyncio.wait_for(ev.wait(),
                                           timeout=self.idle_wait_s)
                except asyncio.TimeoutError:
                    pass
        except BaseException as e:
            self._engine_exc = e
            for fut in self._futures.values():
                if not fut.done():
                    fut.set_exception(
                        RuntimeError(f"engine crashed: {e!r}"))
            self._futures.clear()
            raise
        return self.stats

    async def drain(self, poll_s: float = 0.001):
        """Wait (without closing) until nothing is queued or in flight."""
        while not self._drained():
            await asyncio.sleep(poll_s)


class DisaggEngine(BatchServer):
    """Disaggregated prefill/decode serving over the coherent KV pool: the
    composition of the paper's two killer apps on real traffic.

    The slot table is partitioned into a **prefill worker** range
    ``[0, prefill_slots)`` and a **decode worker** range
    ``[prefill_slots, prefill_slots + batch_slots)``; both workers share
    ONE ``KVBlockPager`` arena (the CXL-coherent pool), so prefix caching
    and near/far tiering span workers unchanged.  The prefill worker
    admits requests and prefills them (chunked or one-shot) in its range;
    when a prompt is fully resident it parks the request in HANDOFF and,
    per request, claims a decode-slot RAO FAA ticket
    (``DECODE_TICKET_ADDR``, its own counter word), encodes a
    ``HANDOFF_SCHEMA`` wire message (ticket, block-table row, prompt
    metadata) through ``core.rpc`` and bills it via ``niccost.on_egress``.
    The decode worker decodes the message (``on_ingress``), binds a slot
    in its own range from the ticket hint, and re-homes the pages with
    ``KVBlockPager.handoff``, a pure metadata move over the coherent pool,
    billed by ``niccost.on_kv_handoff`` as coherent mapping against the
    per-block PCIe DMA re-copy a non-coherent deployment would pay.

    Greedy decode equals the monolith's at f32: moving a row between
    slots changes nothing the kernels compute for it.  Backpressure is
    natural: with every decode slot busy, finished prefills wait in
    HANDOFF holding their prefill slot, which pauses admission, so no
    token is ever dropped.
    """

    def __init__(self, model, *, batch_slots: int = 4,
                 prefill_slots: Optional[int] = None, **kw):
        # batch_slots sizes the decode worker (the monolith meaning: how
        # many requests decode at once); the prefill worker gets its own
        # range on top, by default the same size
        self.decode_slots = int(batch_slots)
        self.prefill_slots = int(batch_slots if prefill_slots is None
                                 else prefill_slots)
        if self.prefill_slots < 1:
            raise ValueError(f"prefill_slots must be >= 1, got "
                             f"{self.prefill_slots}")
        if self.decode_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got "
                             f"{self.decode_slots}")
        super().__init__(model,
                         batch_slots=self.prefill_slots + self.decode_slots,
                         **kw)
        if not self.paged:
            raise ValueError("disaggregated serving requires the paged KV "
                             "plane (paged_kv) — the handoff moves pool "
                             "pages by block-table row")
        self._handoffs: Deque[Request] = deque()
        self.stats.update({"handoffs": 0, "handoff_blocks": 0,
                           "handoff_wire_bytes": 0})

    # ------------------------------------------------- worker partition
    def _ticket_hint(self, ticket: int) -> int:
        return ticket % self.prefill_slots

    def _bind_admit(self, req: Request) -> int:
        return self.table.bind(req, lo=0, hi=self.prefill_slots)

    def _admit_free(self) -> int:
        return self.table.free_in(0, self.prefill_slots)

    def _after_prefill(self, req: Request, now: float):
        # the first token is emitted here (TTFT); a HANDOFF slot drops out
        # of the engagement plan, so its pages may demote while parked and
        # promote on the decode side's next plan
        req.to(RequestState.HANDOFF, now)
        self._handoffs.append(req)

    # ----------------------------------------------------- wire handoff
    def _handoff_msg(self, req: Request, row: np.ndarray) -> Dict:
        return {1: req.req_id,
                2: req.decode_ticket,
                3: len(req.prompt),
                4: req.max_new,
                5: [int(t) for t in req.generated],
                6: [int(p) for p in row],
                7: self.family,
                8: "prefill->decode"}

    def _do_handoffs(self, now: float):
        """Drain HANDOFF-parked requests into free decode-worker slots,
        one wire message per request."""
        moved = False
        while self._handoffs and \
                self.table.free_in(self.prefill_slots, self.slots):
            req = self._handoffs.popleft()
            src = req.slot
            full_row = np.asarray(self.pager.block_table()[src])
            live = np.nonzero(full_row >= 0)[0]
            # occupied span: leading -1s are window-released blocks the
            # decode worker must keep masked dead at the same columns
            span = int(live[-1]) + 1 if live.size else 0
            # prefill worker: claim the decode slot ticket + publish
            req.decode_ticket = self.table.claim_ticket(DECODE_TICKET_ADDR)
            self._unbilled_tickets += 1
            msg = self._handoff_msg(req, full_row[:span])
            buf = wire.encode(msg)
            self.niccost.on_egress(msg)
            # decode worker: consume the message, bind in its own range,
            # map the same pool pages (no KV bytes move)
            got = wire.decode(buf, HANDOFF_SCHEMA)
            self.niccost.on_ingress(got)
            self.table.release(src)
            req.slot = self.prefill_slots + got[2] % self.decode_slots
            dst = self.table.bind(req, lo=self.prefill_slots, hi=self.slots)
            n_live = self.pager.handoff(src, dst)
            self.niccost.on_kv_handoff(n_live, self.pager.block_bytes)
            new_row = np.asarray(self.pager.block_table()[dst])
            if _as_list(got.get(6, [])) != new_row[:span].tolist():
                raise RuntimeError(
                    f"handoff page-id mismatch for req {req.req_id}: wire "
                    f"{got.get(6)} != pager row {new_row[:span].tolist()}")
            req.to(RequestState.DECODE, now)
            self.stats["handoffs"] += 1
            self.stats["handoff_blocks"] += n_live
            self.stats["handoff_wire_bytes"] += len(buf)
            moved = True
        if moved:
            self._tier_dirty = True            # slot rows moved ranges


class AsyncDisaggEngine(AsyncBatchServer, DisaggEngine):
    """Asyncio front-end over the disaggregated engine (the engine
    coroutine drives ``step``, which runs admission, prefill, handoff and
    decode each tick)."""
