"""Serving runtime on the paged, chunked KV plane (PyTorch counterpart of
``repro/runtime/server.py``).

``BatchServer`` is the synchronous tick loop of the JAX engine, restricted
to the plane every attention family serves on by default:

  * requests arrive as wire messages (``core.rpc``) and are billed by the
    SimCXL NIC cost model (``runtime.niccost``);
  * slots are claimed through the RAO fetch-and-add ticket sequencer;
  * the KV cache is a pooled page arena indexed by the host-side
    ``KVBlockPager`` block table;
  * a prompt streams in one bucket-padded chunk per tick
    (``_prefill_step`` -> ``model.paged_prefill_chunk``), and DECODE slots
    advance one token per tick in one batched ``model.paged_decode_step``
    (``_decode_tick``).  On a CUDA device both run their attention in the
    hand-written kernels of ``kernels.ops``; on the CPU in the plain
    versions.

Every option outside this plane raises, naming the later slice of the port
that brings it: the dense cache (``paged_kv=False``), one-shot prefill
(``prefill_chunk=0``), the prefix cache, KV tiering, paged sliding-window
attention, disaggregated and asyncio engines.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import rpc as wire
from repro_torch.core.pool import CoherentMemoryPool
from repro_torch.device import device_hbm_bytes, resolve_device
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


def _tree_device(tree) -> Optional[torch.device]:
    if isinstance(tree, dict):
        for v in tree.values():
            d = _tree_device(v)
            if d is not None:
                return d
        return None
    return tree.device


class BatchServer:
    """Slot-based continuous batching on the paged KV plane: chunked
    bucketed prefill plus batched paged decode.

    Per-request lifecycle is the scheduler state machine; slot claims go
    through the RAO ticket sequencer; the pager owns the block table of
    the pooled arena.  ``nic_cost=None`` disables the SimCXL NIC
    projection.  ``device`` defaults to the CUDA card; ``params`` must
    live on it (``model.init`` draws them there when omitted).
    """

    def __init__(self, model, *, batch_slots: int = 4, max_len: int = 128,
                 params=None, generator: Optional[torch.Generator] = None,
                 device=None, block_tokens: int = 16,
                 nic_cost: Optional[object] = True,
                 pool: Optional[CoherentMemoryPool] = None,
                 paged_kv="auto", prefill_chunk="auto",
                 prefill_buckets: int = 4, sync_timers: bool = False,
                 prefix_cache: bool = False, prefix_watermark: float = 0.0,
                 kv_overcommit: float = 1.0,
                 kv_near_blocks: Optional[int] = None,
                 kv_demote_after: Optional[int] = None):
        cfg = model.cfg
        if paged_kv not in ("auto", None, True):
            raise _later("the dense (slots, max_len) KV cache plane "
                         "(paged_kv=False)", "the dense-cache plane")
        if prefill_chunk in ("auto", None):
            prefill_chunk = min(64, max_len)
        prefill_chunk = int(prefill_chunk)
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        if prefill_chunk == 0:
            raise _later("one-shot exact-length prefill (prefill_chunk=0)",
                         "the other paged engine planes")
        if prefix_cache or prefix_watermark:
            raise _later("the KV prefix cache (prefix_cache)",
                         "the other paged engine planes")
        if kv_overcommit != 1.0 or kv_near_blocks is not None \
                or kv_demote_after is not None:
            raise _later("KV tiering (kv_overcommit / kv_near_blocks / "
                         "kv_demote_after)", "the other paged engine planes")
        if cfg.sliding_window:
            raise _later("paged sliding-window attention with "
                         "release_behind", "the other paged engine planes")

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
        self.paged = True
        self.prefill_chunk = prefill_chunk
        self.chunk_buckets = _prefill_buckets(prefill_chunk, prefill_buckets)
        self.pages = model.init_paged_cache(batch_slots, max_len,
                                            block_tokens, device=self.device)
        kp = self.pages["kp"]
        # k+v bytes per token, derived from the arena itself
        footprint = (2 * kp.numel() * kp.element_size()
                     // (kp.shape[1] * block_tokens), 0)
        # the card's own HBM capacity (the pool's defaults are a TPU's and
        # stay for the CPU only)
        hbm = device_hbm_bytes(self.device)
        if pool is None and hbm is not None:
            pool = CoherentMemoryPool(hbm_bytes=hbm)
        self.table = SlotTable(batch_slots)
        self.queue = AdmissionQueue(continuous=True)
        self.pager = KVBlockPager(None, n_slots=batch_slots,
                                  max_len=max_len, block_tokens=block_tokens,
                                  paged=True, pool=pool,
                                  params_bytes=_tree_nbytes(self.params),
                                  hbm_budget=hbm, track_table=True,
                                  footprint=footprint)
        # the model sized the arena, the pager sized the page table: every
        # page id must address a real (non-trash) arena page
        assert kp.shape[1] == self.pager.near_frames + 1, \
            (tuple(kp.shape), self.pager.near_frames)
        if nic_cost is True:
            self.niccost = NicCostModel()
        elif nic_cost in (None, False):
            self.niccost = NullNicCostModel()
        else:
            self.niccost = nic_cost
        # PyTorch runs eagerly: the engine's step functions are the model's
        # plain callables (jit_fns() lists them under the JAX names)
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
        return {"chunk_prefill": self._chunk_prefill,
                "paged_decode": self._paged_decode}

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

    def _admit(self, now: float) -> List[bytes]:
        """Admit from the queue while slots are free.  Each admission binds
        a slot and streams its prompt in later ticks (no admission-time
        prefill call, no equal-length grouping)."""
        failures: List[bytes] = []
        while self.table.free > 0:
            req = self.queue.pop_admissible(engine_empty=not self.active,
                                            write_index=0)
            if req is None:
                break
            if not req.prompt or req.max_new < 1 or \
                    len(req.prompt) > self.max_len:
                failures.append(self._fail(req, now))
                continue
            self._admit_chunked(req, now)
        return failures

    def _admit_chunked(self, req: Request, now: float):
        """Chunked admission: claim the slot and the fixed-state region;
        prompt pages are allocated chunk by chunk, and the first token
        comes out of the final chunk."""
        req.to(RequestState.PREFILL, now)
        self.table.bind(req)
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
            if req.prefilled >= len(req.prompt):
                req.generated.append(int(nxt[slot]))
                req.to(RequestState.DECODE, now)
                self.stats["prefills"] += 1

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
        """One scheduler tick: admit from queue, advance chunked prefills
        by one chunk, one batched decode step over the DECODE slots."""
        now = time.perf_counter()
        self.stats["ticks"] += 1
        if self._unbilled_tickets:
            self.niccost.on_ticket_batch(self._unbilled_tickets)
            self._unbilled_tickets = 0
        finished = self._admit(now)
        self.stats["admit_wall_s"] += time.perf_counter() - now
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
        lens = np.zeros((self.slots,), np.int32)
        for slot, req in decoding.items():
            last[slot, 0] = req.generated[-1] if req.generated else 0
            lens[slot] = req.pos - 1              # tokens resident in pages
            # grow the block list so the incoming token's page exists
            # before the kernel computes its write location
            self.pager.advance(slot, req.pos)
        t0 = time.perf_counter()
        nb = self._decode_bucket(int(lens.max()) + 1)
        # PREFILLING slots hold live table rows but must be neither
        # attended nor written by the decode step
        btab = self._masked_block_table(decoding, nb)
        logits, self.pages = self._paged_decode(
            self.params, self.pages, self._to_device(last),
            self._to_device(btab), self._to_device(lens))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.stats["decode_wall_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(decoding)
        now = time.perf_counter()
        for slot, req in decoding.items():
            req.generated.append(int(nxt[slot]))
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
        out["paged_kv"] = True
        out["tiered"] = False
        return out

    def nic_report(self) -> dict:
        return self.niccost.report()
