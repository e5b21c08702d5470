"""Serving runtime (PyTorch counterpart of ``repro/runtime/server.py``).

``BatchServer`` is the synchronous tick loop of the JAX engine, on the
paged plane (dense and moe families) with chunked or one-shot prefill,
and on the dense-cache plane (the hybrid family, which has no paged path):

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
  * dense-cache plane: requests are admitted in equal-prompt-length waves
    (the shared write index ``cur``), each group of up to
    ``prefill_batch`` prefilled in one ``model.prefill`` to ``max_len``
    and spliced into the (slots, max_len) cache; every tick decodes all
    slots in one ``model.decode_step``, and the pager only accounts.
On a CUDA device the steps run their attention, norms, SSD scans (and,
for the moe family, the expert GEMMs and the gated combine) in the
hand-written kernels of ``kernels.ops``; on the CPU in the plain versions.

Every option outside these planes raises, naming the later slice of the
port that brings it: the dense cache of the dense and moe families
(``paged_kv=False``, with its sliding-window ring), KV tiering,
disaggregated and asyncio engines.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

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


def _later(what: str, slice_name: str):
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the port's slice for {slice_name}")


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _splice_rows_tree(cache, cache1, slots: torch.Tensor, n_slots: int):
    """Write a B=k prefill cache into batch rows ``slots`` of the shared
    cache, in place (``index_copy_``): stacked (L, B, ...) leaves on axis
    1, per-batch (B, ...) leaves on axis 0, cast to the shared leaf's
    dtype; scalars pass through (the caller owns the write index)."""
    k = slots.shape[0]
    for name, full in cache.items():
        one = cache1[name]
        if one.dim() == 0:
            continue
        if one.dim() >= 2 and one.shape[1] == k and full.shape[1] == n_slots:
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
    plane (``paged_kv`` resolves there for a model without a paged path)
    equal-length admission waves, grouped prefill spliced into the dense
    cache, and batched decode of every slot.

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
        if not paged_kv and has_paged:
            what = "the sliding-window ring of the dense (slots, max_len) " \
                "KV cache plane" if cfg.sliding_window else \
                "the dense (slots, max_len) KV cache plane"
            raise _later(f"{what} (paged_kv=False) of the dense and moe "
                         f"families", "the dense-cache plane of the dense "
                         "family")
        self.paged = bool(paged_kv)
        # prefill is chunk/pad-invariant iff routing decisions are a pure
        # per-token function: every family except capacity-factor MoE,
        # whose expert drops depend on the token population of each
        # dispatch call.  Dropless MoE (the serving default of
        # launch.serve) runs the chunked bucketed pipeline like the rest.
        chunk_invariant = cfg.family != "moe" or \
            cfg.moe_routing == "dropless"
        if not self.paged:
            if prefill_chunk not in ("auto", None, 0):
                raise ValueError("prefill_chunk requires the paged KV plane "
                                 "(paged_kv)")
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
        if kv_overcommit != 1.0 or kv_near_blocks is not None \
                or kv_demote_after is not None:
            raise _later("KV tiering (kv_overcommit / kv_near_blocks / "
                         "kv_demote_after)", "the other paged engine planes")
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
        # paged sliding-window attention: release_behind frees the blocks
        # behind the window as it advances
        self.window = int(cfg.sliding_window or 0)

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
        self.prefill_chunk = prefill_chunk
        self.chunk_buckets = _prefill_buckets(prefill_chunk, prefill_buckets) \
            if prefill_chunk else ()
        self.prefill_batch = max(1, prefill_batch)
        if self.paged:
            self.pages = model.init_paged_cache(batch_slots, max_len,
                                                block_tokens,
                                                device=self.device)
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
        # shared-write-index caches admit in equal-prompt-length waves;
        # the paged plane (per-slot lengths) admits continuously
        self.queue = AdmissionQueue(continuous=self.paged)
        self.pager = KVBlockPager(self.cache, n_slots=batch_slots,
                                  max_len=max_len, block_tokens=block_tokens,
                                  paged=True, pool=pool,
                                  params_bytes=_tree_nbytes(self.params),
                                  hbm_budget=hbm, track_table=self.paged,
                                  footprint=footprint,
                                  prefix_cache=self.prefix_cache)
        # the model sized the arena, the pager sized the page table: every
        # page id must address a real (non-trash) arena page
        if self.paged:
            assert self.pages["kp"].shape[1] == self.pager.near_frames + 1, \
                (tuple(self.pages["kp"].shape), self.pager.near_frames)
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
        self._decode = model.decode_step
        self._page_write = model.paged_prefill_write
        self._chunk_prefill = model.paged_prefill_chunk
        self._paged_decode = model.paged_decode_step
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
            return {"prefill": self._prefill, "decode": self._decode,
                    "splice": _splice_rows_tree}
        fns = {"prefill_exact": self._prefill_exact,
               "paged_decode": self._paged_decode,
               "page_write": self._page_write}
        if self.prefill_chunk:
            fns["chunk_prefill"] = self._chunk_prefill
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
        req.slot = req.ticket % self.slots
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

    def _fail(self, req: Request, now: float) -> bytes:
        req.to(RequestState.FAILED, now)
        self.stats["failed"] += 1
        self.completed_reqs.append(req)
        return encode_response(req.req_id, [])

    def _admit_group(self, reqs: List[Request], now: float):
        """Prefill a group of equal-prompt-length requests in one
        exact-length call (B = len(reqs)), then install it: on the paged
        plane one page write that touches only the admitted slots' pages,
        on the dense plane one in-place splice of the slots' cache rows
        and the shared write index."""
        for req in reqs:
            req.to(RequestState.PREFILL, now)
        slot_arr = [self.table.bind(req) for req in reqs]
        toks = np.asarray([r.prompt for r in reqs], np.int32)
        S = int(toks.shape[1])
        prefill = self._prefill_exact if self.paged else self._prefill
        logits, cache1 = prefill(self.params, self._to_device(toks))
        # only the (G,) greedy ids leave the device
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        t1 = time.perf_counter()
        for row, req in enumerate(reqs):
            req.generated.append(int(nxt[row]))
            req.to(RequestState.DECODE, t1)

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
            self.pages = self._page_write(
                self.pages, cache1["k"], cache1["v"],
                self._to_device(np.asarray(ids, np.int32)), S, skip)
            if self.prefix_cache and shareable:
                for slot, req in zip(slot_arr, reqs):
                    self.pager.publish_prefix(slot, req.prompt)
        else:
            self.cache = _splice_rows_tree(
                self.cache, cache1, self._to_device(
                    np.asarray(slot_arr, np.int64)), self.slots)
            # shared write index: admission waves have equal prompt
            # lengths, so overwriting it never moves it under an in-flight
            # request
            self.cache["cur"] = cache1["cur"]
            for slot in slot_arr:
                self.pager.admit(slot, self.table.active[slot].pos)
        if self.sync_timers:
            self._sync()
        self.stats["splice_wall_s"] += time.perf_counter() - tw
        self.stats["prefills"] += len(reqs)
        self.stats["admitted"] += len(reqs)

    def _admit(self, now: float) -> List[bytes]:
        """Admit from the queue while slots are free.  Chunked: each
        admission binds a slot and streams its prompt in later ticks.
        One-shot: consecutive requests with the same prompt length
        prefill as one batched call (up to ``prefill_batch``)."""
        failures: List[bytes] = []
        group: List[Request] = []

        def flush():
            if group:
                self._admit_group(group, now)
                group.clear()

        while self.table.free > len(group):
            empty = not self.active and not group
            if self.paged or empty:
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
        self.table.bind(req)
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
        return buf

    def _exhausted(self, req: Request) -> bool:
        # JAX skips the max_len cap only for continuously admitted
        # (recurrent-state, xLSTM) families, which the port does not serve
        return len(req.generated) >= req.max_new or req.pos >= self.max_len

    def _harvest(self, now: float) -> List[bytes]:
        return [self._finish(req, now)
                for _, req in sorted(self.active.items())
                if req.state is RequestState.DECODE
                and self._exhausted(req)]

    # ----------------------------------------------------- chunked prefill
    def _prefill_step(self):
        """Advance every PREFILLING slot by one prompt chunk (ragged last
        chunks pad up into ``chunk_buckets``), batched over the full slot
        dimension with the full-width block table."""
        pre = {slot: req for slot, req in self.active.items()
               if req.state is RequestState.PREFILLING}
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
        btab = self._masked_block_table(pre)
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
                req.to(RequestState.DECODE, now)
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

    def step(self) -> List[bytes]:
        """One scheduler tick: admit from queue (one-shot: prefilling each
        admission group), advance chunked prefills by one chunk, one
        batched decode step over the DECODE slots."""
        now = time.perf_counter()
        self.stats["ticks"] += 1
        if self.prefix_cache and self.prefix_watermark:
            # proactive LRU eviction keeps free-page headroom for
            # incoming admissions
            self.pager.evict_to_watermark(self.prefix_watermark)
        if self._unbilled_tickets:
            self.niccost.on_ticket_batch(self._unbilled_tickets)
            self._unbilled_tickets = 0
        finished = self._admit(now)
        self.stats["admit_wall_s"] += time.perf_counter() - now
        if self.prefill_chunk:
            self._prefill_step()
        # prefill emits the first token: single-token requests are already
        # complete and must not burn a decode step
        finished += self._harvest(now)
        return finished + self._decode_tick(now)

    def _decode_tick(self, now: float) -> List[bytes]:
        """One batched decode dispatch over the DECODE slots."""
        self._busy_slot_ticks += len(self.active)
        decoding = {slot: req for slot, req in self.active.items()
                    if req.state is RequestState.DECODE}
        if not decoding:
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
            # PREFILLING slots hold live table rows but must be neither
            # attended nor written by the decode step
            btab = self._masked_block_table(decoding, nb)
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
        return self._harvest(now)

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
    def kv_stats(self) -> dict:
        out = self.pager.stats()
        out["paged_kv"] = self.paged
        out["tiered"] = False
        return out

    def nic_report(self) -> dict:
        return self.niccost.report()
