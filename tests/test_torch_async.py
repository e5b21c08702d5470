"""The port's asyncio ``AsyncBatchServer`` and ``runtime.loadgen`` against
the JAX package's.

Each run drives both packages' ``AsyncBatchServer`` as
``tests/test_differential.py``'s ``_run_async`` does (one engine
coroutine, every request submitted through ``submit_async``, then
``close``) on the same params at f32, and the port's greedy tokens must
equal JAX's:

  * the async rows of the differential suite, chunked and one-shot, for
    tiny mistral-nemo (dense), tiny granite-moe with dropless routing (in
    place of JAX's qwen3 row) and tiny h2o-danube (window 16);
  * the async prefix rows (``test_cached_equals_cold_async``): the cold
    and the ``prefix_cache=True`` run, which hits;
  * ``test_tiered_async_matches``: ``kv_overcommit=2`` with the prefix
    cache, whose whole ``kv_stats()`` equals JAX's too.

Also: the port's ``loadgen.make_trace`` and ``collect_metrics`` equal
JAX's on the same seed; the engine's behaviour on a duplicate id, bad
wire bytes, a crash in ``step``, and ``close`` / ``reopen`` / ``drain``;
and the launcher's ``--arrival poisson``, ``--kv-overcommit`` and
``--kv-near-blocks`` on the CPU.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import rpc as jwire
from repro.models.model import build_model as jax_build_model
from repro.runtime import loadgen as jax_loadgen
from repro.runtime.scheduler import Request as JaxRequest
from repro.runtime.scheduler import RequestState as JaxState
from repro.runtime.server import AsyncBatchServer as JaxAsyncServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.runtime import loadgen
from repro_torch.runtime.scheduler import Request, RequestState
from repro_torch.runtime.server import AsyncBatchServer, encode_request
from test_torch_tier import share_jits

TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, param_dtype="float32",
            cache_dtype="float32")
W = 16                      # the reduced danube config's window
# (arch, overrides, params key, max_len) of each row
ROWS = {
    "dense": ("mistral-nemo-12b", {}, 3, 32),
    "moe": ("granite-moe-3b-a800m", dict(moe_routing="dropless"), 2, 32),
    "swa": ("h2o-danube-3-4b", {}, 5, 2 * W + 16),
}
MODES = {"chunked": {}, "oneshot": dict(prefill_chunk=0)}


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


def _run_async(cls, req_cls, model, params, trace, jits=None, **kw):
    """``_run_async`` of the differential suite: returns the decoded
    outputs and the drained engine.  A JAX engine takes the row's shared
    jitted step functions (``jits``)."""
    async def go():
        srv = cls(model, batch_slots=3, params=params, nic_cost=None, **kw)
        if jits is not None:
            share_jits(srv, jits)
        eng = asyncio.ensure_future(srv.run_engine())
        outs = await asyncio.gather(
            *[srv.submit_async(req_cls(i, list(p), m))
              for i, (p, m) in enumerate(trace)])
        srv.close()
        await eng
        return srv, outs
    srv, outs = asyncio.run(go())
    return outs, srv


def _both(row, trace, **kw):
    """The trace through JAX's async engine and the port's; the port's
    tokens equal JAX's, and neither leaves a page in use or a future."""
    jmodel, jparams, tmodel, tparams, max_len, jits = row
    jout, jsrv = _run_async(JaxAsyncServer, JaxRequest, jmodel, jparams,
                            trace, jits, max_len=max_len, **kw)
    tout, tsrv = _run_async(AsyncBatchServer, Request, tmodel, tparams,
                            trace, max_len=max_len, device="cpu", **kw)
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert len(tout) == len(trace) and tsrv.stats["failed"] == 0
    assert not tsrv._futures and tsrv._drained()
    for key in ("prefills", "prefill_chunks", "decode_steps", "ticks"):
        assert tsrv.stats[key] == jsrv.stats[key], key
    for srv in (tsrv, jsrv):
        if srv.prefix_cache:
            srv.pager.evict_prefixes()
        assert srv.kv_stats()["paged"]["pages_in_use"] == 0, "leaked pages"
    return tsrv, jsrv


@pytest.fixture(scope="module", params=sorted(ROWS))
def row(request):
    arch, over, key, max_len = ROWS[request.param]
    jcfg = jax_reduced(jax_get_config(arch)).replace(**TINY, **over)
    tcfg = reduced(get_config(arch)).replace(**TINY, **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(key))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                torch.float32)
    return request.param, (jmodel, jparams, build_model(tcfg), tparams,
                           max_len, {})


def ragged_trace(fam, seed):
    """The differential suite's ragged traces: single-token, block-
    boundary, multi-chunk and near-capacity prompts (danube: around and
    past the window)."""
    rng = np.random.RandomState(seed)
    if fam == "swa":
        lens_new = [(l, 4) for l in (W // 2, W, W + 5, 2 * W + 3, 3)]
    else:
        lens_new = [(4, 4), (9, 1), (16, 3), (1, 5), (27, 4), (5, 2),
                    (13, 3)]
    return [(rng.randint(1, 127, size=n).tolist(), m) for n, m in lens_new]


def prefix_trace(fam, seed):
    """Shared-system-prompt traffic (TestSharedPrefixDifferential's)."""
    rng = np.random.RandomState(seed)
    prefix_len, tails = (8, (1, 5, W, 3, W + 6, 7)) if fam == "swa" else \
        (16, (1, 5, 9, 12, 3, 7))
    prefix = rng.randint(1, 127, size=prefix_len).tolist()
    return [(prefix + rng.randint(1, 127, size=t).tolist(), 3)
            for t in tails]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_async_plane_matches_jax(row, mode):
    fam, r = row
    tsrv, _ = _both(r, ragged_trace(fam, 4321), **MODES[mode])
    assert tsrv.prefill_chunk == (0 if mode == "oneshot" else
                                  min(64, r[4]))


def test_cached_equals_cold_async(row):
    """The hot run against JAX's; the cold run on the port alone (its
    tokens are held against JAX by ``test_async_plane_matches_jax``'s
    engine), for its tokens and its block count."""
    fam, r = row
    trace = prefix_trace(fam, 77)
    cold_out, cold = _run_async(AsyncBatchServer, Request, r[2], r[3],
                                trace, max_len=r[4], device="cpu",
                                block_tokens=8)
    hot, jhot = _both(r, trace, block_tokens=8, prefix_cache=True)
    assert hot.kv_stats()["prefix"]["hits"] > 0
    assert hot.kv_stats()["prefix"] == jhot.kv_stats()["prefix"]
    assert _outs(cold_out, wire) == {
        q.req_id: q.generated for q in hot.completed_reqs}
    assert hot.kv_stats()["blocks_allocated"] < \
        cold.kv_stats()["blocks_allocated"]


def test_tiered_async_matches(row):
    fam, r = row
    trace = prefix_trace(fam, 91)
    tsrv, jsrv = _both(r, trace, block_tokens=8, prefix_cache=True,
                       kv_overcommit=2.0)
    assert tsrv.tiered
    assert tsrv.kv_stats() == jsrv.kv_stats()


# ------------------------------------------------------------- loadgen
@pytest.mark.parametrize("pattern,kw", [
    ("all-at-once", {}), ("poisson", dict(rate_rps=4.0)),
    ("poisson", dict(rate_rps=3000.0, seed=5)),
    ("bursty", dict(burst=8, gap_s=0.05, seed=2)),
], ids=["all-at-once", "poisson-4", "poisson-3000", "bursty"])
def test_make_trace_equals_jax(pattern, kw):
    got = loadgen.make_trace(pattern, 16, **kw)
    exp = jax_loadgen.make_trace(pattern, 16, **kw)
    np.testing.assert_array_equal(got, exp)


def test_collect_metrics_equals_jax():
    """The same completed requests (one failed, one still decoding) give
    the same metrics in both packages."""
    rng = np.random.RandomState(3)
    reqs = {}
    for pkg, cls, state in (("torch", Request, RequestState),
                            ("jax", JaxRequest, JaxState)):
        rows = []
        for i in range(6):
            r = cls(i, [1, 2, 3], 4)
            r.arrival_t = 10.0 + i
            r.first_token_t = r.arrival_t + 0.1 * (i + 1)
            r.done_t = r.first_token_t + 0.5
            r.generated = list(range(4))
            r.state = state.DONE
            rows.append(r)
        rows[4].state = state.FAILED
        rows[5].state = state.DECODE
        reqs[pkg] = rows
    util = float(rng.rand())
    got = loadgen.collect_metrics(reqs["torch"], 7.5, util, n_submitted=6)
    exp = jax_loadgen.collect_metrics(reqs["jax"], 7.5, util, n_submitted=6)
    assert got.to_dict() == exp.to_dict()
    assert got.completed == 4 and got.tokens_per_s == exp.tokens_per_s


# ---------------------------------------------------- engine behaviour
@pytest.fixture(scope="module")
def dense():
    tcfg = reduced(get_config("mistral-nemo-12b")).replace(**TINY)
    model = build_model(tcfg)
    return model, model.init(torch.Generator().manual_seed(0), "cpu")


def _engine(dense, **kw):
    model, params = dense
    return AsyncBatchServer(model, batch_slots=2, max_len=32, params=params,
                            device="cpu", nic_cost=None, **kw)


def test_duplicate_id_and_bad_wire_leave_no_orphaned_future(dense):
    async def go():
        srv = _engine(dense)
        eng = asyncio.ensure_future(srv.run_engine())
        first = asyncio.ensure_future(
            srv.submit_async(encode_request(7, [1, 2], 20)))
        await asyncio.sleep(0)                  # let it register
        with pytest.raises(ValueError, match="already in flight"):
            await srv.submit_async(encode_request(7, [3], 1))
        with pytest.raises(ValueError, match="truncated varint"):
            await srv.submit_async(b"\xff\xff\xff")
        assert list(srv._futures) == [7]        # neither left a future
        buf = await first                       # the first is still served
        srv.close()
        await eng
        return srv, buf
    srv, buf = asyncio.run(go())
    assert wire.decode(buf, {1: "int", 2: "bytes"})[1] == 7
    assert srv._drained() and srv.stats["completed"] == 1


def test_crash_in_step_fails_every_outstanding_future(dense):
    async def go():
        srv = _engine(dense)

        def boom():
            raise ZeroDivisionError("injected")
        srv.step = boom
        subs = [asyncio.ensure_future(srv.submit_async(
            encode_request(i, [1, 2], 3))) for i in range(3)]
        await asyncio.sleep(0)
        eng = asyncio.ensure_future(srv.run_engine())
        with pytest.raises(ZeroDivisionError):
            await eng
        for s in subs:
            with pytest.raises(RuntimeError, match="engine crashed"):
                await s
        assert not srv._futures
        # later submitters are told at once
        with pytest.raises(RuntimeError, match="engine crashed"):
            await srv.submit_async(encode_request(9, [1], 1))
    asyncio.run(go())


def test_close_reopen_drain(dense):
    """A closed engine refuses new work without leaving a future, drains
    what it holds; ``reopen`` takes a second wave on the same engine and
    ``drain`` waits for it without closing."""
    async def wave(srv, ids):
        eng = asyncio.ensure_future(srv.run_engine())
        outs = await asyncio.gather(*[srv.submit_async(
            encode_request(i, [1 + i, 2], 3)) for i in ids])
        await srv.drain()
        assert not eng.done()                   # drain does not close
        srv.close()
        await eng
        return _outs(outs, wire)

    async def go():
        srv = _engine(dense)
        first = await wave(srv, range(3))
        with pytest.raises(RuntimeError, match="closed"):
            await srv.submit_async(encode_request(5, [1], 1))
        assert srv._drained()
        await srv.run_engine()                  # closed and drained: exits
        srv.reopen()
        second = await wave(srv, range(10, 13))
        return srv, first, second
    srv, first, second = asyncio.run(go())
    assert sorted(first) == [0, 1, 2] and sorted(second) == [10, 11, 12]
    assert all(len(v) == 3 for v in (*first.values(), *second.values()))
    assert srv.stats["completed"] == 6


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("argv,words", [
    (["--arrival", "poisson", "--rate", "50"], "[serve] load:"),
    (["--kv-overcommit", "2"], "[serve] kv tiers:"),
    (["--kv-near-blocks", "1", "--kv-demote-after", "1"],
     "[serve] kv tiers:"),
], ids=["arrival-poisson", "kv-overcommit", "kv-near-blocks"])
def test_launcher_serves_on_cpu(argv, words, capsys):
    out = serve.main(["--device", "cpu", "--requests", "5", "--slots", "2",
                      "--prompt-len", "9", "--max-new", "3", *argv])
    assert len(out) == 5
    text = capsys.readouterr().out
    assert "5/5 completed" in text and words in text


@pytest.mark.parametrize("argv,words", [
    (["--kv-overcommit", "0.5"], ">= 1.0"),
    (["--kv-overcommit", "2", "--kv-near-blocks", "4"], "pass one"),
    (["--kv-demote-after", "2"], "requires active tiering"),
], ids=["overcommit-below-1", "overcommit-and-near", "demote-untiered"])
def test_launcher_validates_tier_options_as_jax(argv, words, capsys):
    with pytest.raises(SystemExit) as ex:
        serve.main(["--device", "cpu", *argv])
    assert ex.value.code == 2
    assert words in capsys.readouterr().err
