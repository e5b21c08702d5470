"""Trace-driven load generation + serving metrics (ROADMAP: sustained load).

Coherent-interconnect wins are measured under sustained concurrent request
pressure, not one-shot microbenchmarks (arXiv:2411.02814) — so the serving
engine ships with a closed-loop load generator: arrival-time traces
(Poisson / bursty / all-at-once), an asyncio driver that submits each
request at its trace time and awaits its response, and a metrics collector
reporting p50/p99 end-to-end latency, time-to-first-token, tokens/sec, and
slot utilization.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ARRIVAL_PATTERNS = ("all-at-once", "poisson", "bursty")


# --------------------------------------------------------------- traces
def poisson_trace(n: int, rate_rps: float, seed: int = 0) -> np.ndarray:
    """Arrival times (s) of a Poisson process: iid Exp(rate) gaps."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return np.cumsum(gaps) - gaps[0]          # first arrival at t=0


def bursty_trace(n: int, burst: int, gap_s: float,
                 jitter_s: float = 0.0, seed: int = 0) -> np.ndarray:
    """Bursts of `burst` simultaneous arrivals every `gap_s` seconds
    (thundering-herd pattern), with optional per-request jitter."""
    rng = np.random.RandomState(seed)
    base = np.repeat(np.arange(-(-n // burst)) * gap_s, burst)[:n]
    if jitter_s > 0:
        base = base + rng.uniform(0.0, jitter_s, size=n)
    return np.sort(base)


def ragged_prompt_lens(n: int, lo: int, hi: int, *, n_distinct: int = 50,
                       seed: int = 0) -> np.ndarray:
    """Ragged prompt lengths for retrace-stress traffic: ``n_distinct``
    distinct values spread over [lo, hi], sampled uniformly per request.
    Each distinct length used to cost the serving engine a fresh XLA
    prefill trace; the chunked bucketed pipeline pays O(buckets) instead
    (benchmarks/serve_bench.py ragged phase, tests/test_differential.py)."""
    if not (1 <= lo <= hi):
        raise ValueError(f"need 1 <= lo <= hi, got ({lo}, {hi})")
    rng = np.random.RandomState(seed)
    levels = np.unique(np.linspace(lo, hi, n_distinct).round().astype(int))
    return levels[rng.randint(0, len(levels), size=n)]


def shared_prefix_prompts(n: int, *, prefix_len: int, tail_lo: int,
                          tail_hi: int, vocab: int = 512,
                          seed: int = 0) -> List[List[int]]:
    """Prompts sharing one system prefix with per-request ragged tails —
    the shared-system-prompt traffic the prefix cache serves: one prefill
    of ``prefix_len`` tokens should back every request (serve_bench's
    shared_prefix phase, tests/test_differential.py)."""
    if prefix_len < 1 or not (1 <= tail_lo <= tail_hi):
        raise ValueError(f"need prefix_len >= 1 and 1 <= tail_lo <= "
                         f"tail_hi, got ({prefix_len}, {tail_lo}, {tail_hi})")
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab, size=prefix_len).tolist()
    tails = rng.randint(tail_lo, tail_hi + 1, size=n)
    return [prefix + rng.randint(1, vocab, size=int(t)).tolist()
            for t in tails]


def make_trace(pattern: str, n: int, *, rate_rps: float = 100.0,
               burst: int = 32, gap_s: float = 0.1,
               seed: int = 0) -> np.ndarray:
    if pattern == "all-at-once":
        return np.zeros(n)
    if pattern == "poisson":
        return poisson_trace(n, rate_rps, seed)
    if pattern == "bursty":
        return bursty_trace(n, burst, gap_s, seed=seed)
    raise ValueError(f"pattern must be one of {ARRIVAL_PATTERNS}")


# -------------------------------------------------------------- metrics
def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


@dataclass
class ServeMetrics:
    """Summary of one serving run (all times in seconds)."""
    n_requests: int
    completed: int
    makespan_s: float
    total_new_tokens: int
    latency_p50_s: float
    latency_p99_s: float
    latency_mean_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    slot_utilization: float
    ttft_mean_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.total_new_tokens / self.makespan_s if self.makespan_s \
            else 0.0

    @property
    def requests_per_s(self) -> float:
        return self.completed / self.makespan_s if self.makespan_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "n_requests": self.n_requests,
            "completed": self.completed,
            "makespan_s": round(self.makespan_s, 4),
            "total_new_tokens": self.total_new_tokens,
            "tokens_per_s": round(self.tokens_per_s, 1),
            "requests_per_s": round(self.requests_per_s, 1),
            "latency_p50_ms": round(self.latency_p50_s * 1e3, 3),
            "latency_p99_ms": round(self.latency_p99_s * 1e3, 3),
            "latency_mean_ms": round(self.latency_mean_s * 1e3, 3),
            "ttft_p50_ms": round(self.ttft_p50_s * 1e3, 3),
            "ttft_p99_ms": round(self.ttft_p99_s * 1e3, 3),
            "ttft_mean_ms": round(self.ttft_mean_s * 1e3, 3),
            "slot_utilization": round(self.slot_utilization, 4),
        }


def collect_metrics(requests: List, makespan_s: float,
                    slot_utilization: float = 0.0,
                    n_submitted: Optional[int] = None) -> ServeMetrics:
    """Build ServeMetrics from completed Request objects (scheduler.py).
    FAILED requests are excluded — their zero-token samples would skew
    the latency percentiles and the completed count."""
    from repro_torch.runtime.scheduler import RequestState
    done = [r for r in requests
            if r.state is RequestState.DONE and r.done_t > 0]
    lats = [r.latency_s for r in done]
    ttfts = [r.ttft_s for r in done if r.first_token_t > 0]
    return ServeMetrics(
        n_requests=n_submitted if n_submitted is not None else len(requests),
        completed=len(done),
        makespan_s=makespan_s,
        total_new_tokens=sum(len(r.generated) for r in done),
        latency_p50_s=_pct(lats, 50), latency_p99_s=_pct(lats, 99),
        latency_mean_s=float(np.mean(lats)) if lats else 0.0,
        ttft_p50_s=_pct(ttfts, 50), ttft_p99_s=_pct(ttfts, 99),
        ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
        slot_utilization=slot_utilization,
    )


# ------------------------------------------------------ synthetic model
class SyntheticModel:
    """Model-API stub (pure numpy, no jax dispatch): a deterministic
    next-token function with an optional per-step service time.  Lets the
    load generator exercise the scheduler/admission/paging machinery at
    10^3–10^4 request scale; use with ``BatchServer(..., jit=False)``.

    The cache carries a stand-in per-token KV leaf (``kv``) and the model
    sets ``paged_kv_footprint`` so the KVBlockPager accounts real blocks
    for these runs — without it every scheduler-scale benchmark would
    report ``blocks_allocated == 0`` and the paging/placement layer would
    go unexercised (admission stays continuous: the scheduler treats the
    stub as a recurrent family).
    """

    paged_kv_footprint = True     # cache has a per-token leaf to page

    class _Cfg:
        family = "ssm"            # recurrent-state: continuous admission

        def __init__(self, vocab):
            self.vocab = vocab

    def __init__(self, vocab: int = 512, step_time_s: float = 0.0,
                 kv_bytes_per_token: int = 16):
        self.cfg = self._Cfg(vocab)
        self.step_time_s = step_time_s
        self.kv_feat = max(1, kv_bytes_per_token // 4)   # f32 lanes

    def init(self, key=None):
        return {}

    def init_cache(self, batch: int, max_len: int):
        return {"kv": np.zeros((1, batch, max_len, self.kv_feat),
                               np.float32),
                "last": np.zeros((batch, 1), np.int64),
                "cur": np.zeros((), np.int64)}

    def _logits(self, nxt):
        out = np.zeros((nxt.shape[0], self.cfg.vocab), np.float32)
        out[np.arange(nxt.shape[0]), nxt] = 1.0
        return out

    def prefill(self, params, batch, mesh=None, max_len=None):
        if self.step_time_s:
            time.sleep(self.step_time_s)
        toks = np.asarray(batch["tokens"])
        B = toks.shape[0]
        T = max_len if max_len is not None else toks.shape[1]
        cache = {"kv": np.zeros((1, B, T, self.kv_feat), np.float32),
                 "last": ((toks.sum(axis=1) + toks.shape[1])
                          % self.cfg.vocab)[:, None].astype(np.int64),
                 "cur": np.asarray(toks.shape[1], np.int64)}
        return self._logits(cache["last"][:, 0]), cache

    def decode_step(self, params, cache, tokens, mesh=None):
        if self.step_time_s:
            time.sleep(self.step_time_s)
        nxt = (np.asarray(tokens)[:, 0] * 31 + 7) % self.cfg.vocab
        cache = {"kv": cache["kv"],
                 "last": nxt[:, None].astype(np.int64),
                 "cur": cache["cur"] + 1}
        return self._logits(nxt), cache


# --------------------------------------------------------- async driver
async def drive_async(server, requests: List, arrivals: Sequence[float],
                      *, time_scale: float = 1.0) -> Tuple[List[bytes],
                                                           ServeMetrics]:
    """Closed-loop driver: submit each request at its (scaled) trace time,
    run the engine concurrently, await every response.

    `server` is an AsyncBatchServer (runtime.server).  Returns the wire
    responses in request order plus the run's ServeMetrics.
    """
    t0 = time.perf_counter()

    async def submit_at(req, at_s):
        delay = at_s * time_scale - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        if hasattr(req, "arrival_t"):       # wire bytes stamp at submit
            req.arrival_t = time.perf_counter()
        return await server.submit_async(req)

    engine = asyncio.ensure_future(server.run_engine())
    try:
        outs = await asyncio.gather(*[submit_at(r, a)
                                      for r, a in zip(requests, arrivals)])
    finally:
        server.close()
        # return_exceptions: an engine crash already failed the request
        # futures above (gather raised) — don't mask that, don't hang here
        await asyncio.gather(engine, return_exceptions=True)
    if engine.done() and not engine.cancelled() \
            and engine.exception() is not None:
        raise engine.exception()
    makespan = time.perf_counter() - t0
    metrics = collect_metrics(server.completed_reqs, makespan,
                              server.slot_utilization,
                              n_submitted=len(requests))
    return list(outs), metrics


def run_closed_loop(server, requests: List, arrivals: Sequence[float],
                    *, time_scale: float = 1.0) -> Tuple[List[bytes],
                                                         ServeMetrics]:
    """Synchronous entry point around ``drive_async`` (owns the loop)."""
    return asyncio.run(drive_async(server, requests, arrivals,
                                   time_scale=time_scale))
