"""The port's disaggregated engines against the JAX reference.

``TestDisaggDifferential`` of ``tests/test_differential.py`` through the
port's ``DisaggEngine`` / ``AsyncDisaggEngine`` and the JAX ones on the
same params, over rows dense (tiny mistral-nemo), moe (tiny granite-moe
with dropless routing, the MoE config the port serves, in place of JAX's
qwen3 row) and swa (tiny h2o-danube, window 16):

  * chunked and one-shot with the prefix cache on the tiered arena
    (``prefix_cache=True, kv_overcommit=2``): greedy tokens equal to
    JAX's and to the port's monolithic ``BatchServer``; the handoff
    counts, the scheduler counts and the whole ``kv_stats()`` equal to
    JAX's;
  * the async engine with one prefill slot;
  * ``nic_report()``: the ingress, egress, ticket and kv_handoff events
    counted as JAX counts them, their projected times within 1e-9
    relative, the coherent handoff cheaper than the DMA re-copy;
  * worker isolation (prefill work only in ``[0, P)``, decode only in
    ``[P, P + B)``) and decode tickets exactly ``[0, n)``;
  * the three ``ValueError`` s, and the launcher's ``--disagg`` /
    ``--prefill-slots`` on the CPU.

All at f32, so greedy argmax equality is exact.
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
from repro.runtime.server import AsyncDisaggEngine as JaxAsyncDisaggEngine
from repro.runtime.server import DisaggEngine as JaxDisaggEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.runtime import (
    AsyncDisaggEngine, BatchServer, DisaggEngine, RequestState,
)
from repro_torch.runtime.server import (
    DECODE_TICKET_ADDR, HANDOFF_SCHEMA, encode_request,
)

# the _tiny overrides of tests/test_differential.py, at f32
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, param_dtype="float32",
            cache_dtype="float32")
BT = 8
# row -> (arch, config overrides, params key, max_len)
ROWS = {
    "dense": ("mistral-nemo-12b", {}, 3, 32),
    "moe": ("granite-moe-3b-a800m", dict(moe_routing="dropless"), 2, 32),
    "swa": ("h2o-danube-3-4b", {}, 5, 2 * 16 + 16),
}
MODES = {"chunked": {}, "oneshot": dict(prefill_chunk=0)}
COUNTS = ("prefills", "prefill_chunks", "decode_steps", "completed",
          "failed", "admitted", "ticks", "decode_tokens", "handoffs",
          "handoff_blocks", "handoff_wire_bytes")


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


def disagg_trace(vocab, seed):
    """TestDisaggDifferential's trace: one block-long shared prefix and
    tails of 1-12 tokens; the max_new = 1 request hands off already
    exhausted (its only token came from the prefill worker)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab - 1, size=BT).tolist()
    return [(prefix + rng.randint(1, vocab - 1, size=t).tolist(), m)
            for t, m in ((1, 3), (9, 1), (5, 4), (12, 3), (3, 2), (7, 3))]


def share_jits(jsrv, jits):
    """Give a JAX engine the jitted step functions of the row's earlier
    engines, so each shape compiles once per row."""
    for name, fn in jsrv.jit_fns().items():
        if name in jits:
            setattr(jsrv, "_" + name, jits[name])
        else:
            jits[name] = fn
    return jsrv


@pytest.fixture(scope="module", params=sorted(ROWS))
def row(request):
    arch, over, key, max_len = ROWS[request.param]
    jcfg = jax_reduced(jax_get_config(arch)).replace(**TINY, **over)
    tcfg = reduced(get_config(arch)).replace(**TINY, **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(key))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                torch.float32)
    trace = disagg_trace(128, 4321 + key)
    return request.param, jmodel, jparams, build_model(tcfg), tparams, \
        trace, max_len, {}


def _drive(srv, trace):
    for i, (p, m) in enumerate(trace):
        srv.submit_wire(encode_request(i, p, m))
    return srv.run_until_drained()


def _drained(srv):
    """Retained prefix pages are deliberate: flush them, then nothing may
    remain, near or far."""
    if srv.prefix_cache:
        srv.pager.evict_prefixes()
    kv = srv.kv_stats()
    far = kv["tier"]["far_resident"] if kv["tiered"] else 0
    return kv["paged"]["pages_in_use"] == 0 and far == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_disagg_matches_jax_and_monolith(row, mode):
    fam, jmodel, jparams, tmodel, tparams, trace, max_len, jits = row
    kw = dict(max_len=max_len, block_tokens=BT, prefix_cache=True,
              kv_overcommit=2.0, nic_cost=None, **MODES[mode])
    jsrv = share_jits(JaxDisaggEngine(jmodel, batch_slots=2,
                                      prefill_slots=2, params=jparams, **kw),
                      jits)
    tsrv = DisaggEngine(tmodel, batch_slots=2, prefill_slots=2,
                        params=tparams, device="cpu", **kw)
    mono = BatchServer(tmodel, batch_slots=4, params=tparams, device="cpu",
                       **kw)
    jout, tout, mout = (_drive(s, trace) for s in (jsrv, tsrv, mono))
    got = _outs(tout, wire)
    assert got == _outs(jout, jwire), "tokens differ from JAX's"
    assert got == _outs(mout, wire), "disaggregation changed greedy tokens"
    assert sorted(tout) == sorted(jout)          # byte-identical responses
    assert tsrv.tiered and tsrv.slots == 4
    assert tsrv.stats["handoffs"] == len(trace)
    assert tsrv.stats["handoff_blocks"] > 0
    assert {k: tsrv.stats[k] for k in COUNTS} == \
        {k: jsrv.stats[k] for k in COUNTS}
    assert tsrv.kv_stats() == jsrv.kv_stats()
    assert _drained(tsrv) and _drained(jsrv)


def test_async_disagg_matches_jax(row):
    fam, jmodel, jparams, tmodel, tparams, trace, max_len, jits = row
    kw = dict(batch_slots=2, prefill_slots=1, max_len=max_len,
              block_tokens=BT, prefix_cache=True, nic_cost=None)

    async def go(srv):
        eng = asyncio.ensure_future(srv.run_engine())
        outs = await asyncio.gather(
            *[srv.submit_async(encode_request(i, p, m))
              for i, (p, m) in enumerate(trace)])
        srv.close()
        await eng
        return outs
    jsrv = share_jits(JaxAsyncDisaggEngine(jmodel, params=jparams, **kw),
                      jits)
    tsrv = AsyncDisaggEngine(tmodel, params=tparams, device="cpu", **kw)
    jout, tout = asyncio.run(go(jsrv)), asyncio.run(go(tsrv))
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert tsrv.stats["handoffs"] == jsrv.stats["handoffs"] == len(trace)
    assert tsrv.stats["handoff_blocks"] == jsrv.stats["handoff_blocks"]
    assert tsrv.kv_stats() == jsrv.kv_stats()
    assert not tsrv._futures and _drained(tsrv)


def test_handoff_events_are_priced_as_jax(row):
    fam, jmodel, jparams, tmodel, tparams, trace, max_len, jits = row
    kw = dict(batch_slots=2, prefill_slots=2, max_len=max_len,
              block_tokens=BT)
    jsrv = share_jits(JaxDisaggEngine(jmodel, params=jparams, **kw), jits)
    tsrv = DisaggEngine(tmodel, params=tparams, device="cpu", **kw)
    assert _outs(_drive(tsrv, trace), wire) == \
        _outs(_drive(jsrv, trace), jwire)
    trep, jrep = tsrv.nic_report(), jsrv.nic_report()
    for kind in ("ingress", "egress", "ticket", "kv_handoff"):
        assert trep[kind]["n"] == jrep[kind]["n"] > 0, kind
        for t in ("pcie_us", "cxl_us"):
            assert trep[kind][t] > 0.0
            np.testing.assert_allclose(trep[kind][t], jrep[kind][t],
                                       rtol=1e-9, err_msg=f"{kind} {t}")
    assert trep["kv_handoff"]["speedup_x"] > 1.0
    assert trep["kv_handoff"]["n"] == tsrv.stats["handoff_blocks"]


def test_workers_stay_in_their_ranges(row):
    """Prefill work binds only in [0, P); decode binding happens only at
    handoff, keyed by the RAO ticket off its own counter word, so the
    claimed tickets are exactly [0, n); every wire message decodes to the
    slot's block-table row."""
    fam, jmodel, jparams, tmodel, tparams, trace, max_len, jits = row
    srv = DisaggEngine(tmodel, batch_slots=2, prefill_slots=2,
                       max_len=max_len, params=tparams, device="cpu",
                       block_tokens=BT, nic_cost=None)
    for i, (p, m) in enumerate(trace):
        srv.submit_wire(encode_request(i, p, m))
    seen_prefill, seen_decode = set(), set()
    while srv.active or len(srv.queue):
        srv.step()
        for s, r in srv.table.active.items():
            if r.state in (RequestState.PREFILL, RequestState.PREFILLING,
                           RequestState.HANDOFF):
                seen_prefill.add(s)
            elif r.state is RequestState.DECODE:
                seen_decode.add(s)
    assert seen_prefill <= set(range(srv.prefill_slots))
    assert seen_decode <= set(range(srv.prefill_slots, srv.slots))
    assert seen_decode, "no request ever decoded in the decode range"
    tickets = sorted(r.decode_ticket for r in srv.completed_reqs)
    assert tickets == list(range(len(trace)))
    # one admission ticket (address 0) and one decode ticket
    # (DECODE_TICKET_ADDR) a request, each counter word on its own
    assert srv.table.tickets_issued == 2 * len(trace)
    assert srv.table.claim_ticket(DECODE_TICKET_ADDR) == len(trace)
    assert srv.table.claim_ticket() == len(trace)
    req = srv.completed_reqs[0]
    msg = wire.decode(wire.encode(srv._handoff_msg(req, np.array([3, 1]))),
                      HANDOFF_SCHEMA)
    assert msg[1] == req.req_id and msg[6] == [3, 1] and \
        msg[8] == "prefill->decode"
    assert _drained(srv)


# the three ValueErrors of test_disagg_requires_paged_plane
BAD = {
    "dense-plane": (dict(batch_slots=2, paged_kv=False), "paged"),
    "no-prefill-slots": (dict(batch_slots=2, prefill_slots=0),
                         "prefill_slots"),
    "no-decode-slots": (dict(batch_slots=0, prefill_slots=1), "batch_slots"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_disagg_refusals_equal_jax(name):
    jcfg = jax_reduced(jax_get_config("mistral-nemo-12b")).replace(**TINY)
    tcfg = reduced(get_config("mistral-nemo-12b")).replace(**TINY)
    kw, words = BAD[name]
    jmodel = jax_build_model(jcfg)
    tmodel = build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                torch.float32)
    with pytest.raises(ValueError, match=words) as jerr:
        JaxDisaggEngine(jmodel, max_len=16, params=jparams, nic_cost=None,
                        **kw)
    with pytest.raises(ValueError, match=words) as terr:
        DisaggEngine(tmodel, max_len=16, params=tparams, device="cpu",
                     nic_cost=None, **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arrival", ["all-at-once", "poisson"])
def test_launcher_serves_disagg_on_cpu(arrival, capsys):
    out = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                      "--prompt-len", "9", "--max-new", "3", "--disagg",
                      "--prefill-slots", "2", "--arrival", arrival,
                      "--rate", "200"])
    assert len(out) == 3
    text = capsys.readouterr().out
    assert "3/3 completed" in text
    assert "disagg: 2 prefill + 2 decode slots; 3 handoffs" in text


@pytest.mark.parametrize("argv,words", [
    (["--disagg", "--no-paged-kv"], "drop --no-paged-kv"),
    (["--prefill-slots", "2"], "--prefill-slots requires --disagg"),
    (["--disagg", "--prefill-slots", "0"], "--prefill-slots must be >= 1"),
], ids=["dense-plane", "without-disagg", "zero"])
def test_launcher_refuses_bad_disagg_options(argv, words, capsys):
    with pytest.raises(SystemExit) as ex:
        serve.main(["--device", "cpu", *argv])
    assert ex.value.code == 2
    assert words in capsys.readouterr().err
