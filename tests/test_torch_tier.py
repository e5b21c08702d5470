"""The port's tiered near/far KV arena against the JAX engine's.

``TestTieredDifferential`` of ``tests/test_differential.py`` through the
port's ``BatchServer`` and the JAX one on the same params: a trace of
requests sharing one block-aligned prefix, with the prefix cache on,
chunked and one-shot at ``kv_overcommit=2``, pressured at one slot's
worth of near frames, and with ``kv_demote_after=1``.  Rows: tiny
mistral-nemo, tiny granite-moe with dropless routing (the MoE config the
port serves, in place of JAX's qwen3 row) and tiny h2o-danube (window
16).  Each run's greedy tokens, scheduler counts and whole ``kv_stats()``
(the ``"tier"`` section included) equal JAX's.  All at f32, so greedy
argmax equality is exact.

Also: the six bad knob sets of ``test_knob_validation`` raise
``ValueError`` in both packages; ``lm_kv_migrate`` equals JAX's on plain
demotions, plain promotions and the swap case (trash frames excluded);
and a seeded churn of ``KVBlockPager`` operations gives the same
migration plans, ``to_near`` maps and stats in JAX's pager and the
port's copy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import rpc as jwire
from repro.models.model import build_model as jax_build_model
from repro.models.transformer import lm_kv_migrate as jax_kv_migrate
from repro.runtime.scheduler import KVBlockPager as JaxPager
from repro.runtime.server import BatchServer as JaxBatchServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.models.transformer import lm_kv_migrate
from repro_torch.runtime.scheduler import KVBlockPager, blocks_for
from repro_torch.runtime.server import BatchServer, encode_request

# the _tiny overrides of tests/test_differential.py, at f32
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, param_dtype="float32",
            cache_dtype="float32")
BT = 8
ROWS = {
    "dense": ("mistral-nemo-12b", {}, 3, 32),
    "moe": ("granite-moe-3b-a800m", dict(moe_routing="dropless"), 2, 32),
    "swa": ("h2o-danube-3-4b", {}, 5, 2 * 16 + 16),
}
RUNS = {
    "chunked": dict(prefix_cache=True, kv_overcommit=2.0),
    "oneshot": dict(prefix_cache=True, kv_overcommit=2.0, prefill_chunk=0),
    "pressured": dict(prefix_cache=True, kv_near_blocks="slot"),
    "demote-after": dict(kv_overcommit=2.0, kv_demote_after=1),
}


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


def _tiny_pair(fam, key=None):
    """JAX model + params and the port's model + bridged params."""
    arch, over, k, max_len = ROWS[fam]
    jcfg = jax_reduced(jax_get_config(arch)).replace(**TINY, **over)
    tcfg = reduced(get_config(arch)).replace(**TINY, **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(k if key is None else key))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                torch.float32)
    return jmodel, jparams, build_model(tcfg), tparams, max_len


def tier_trace(vocab, seed):
    """TestTieredDifferential's trace: one block-long shared prefix and
    tails of 1-12 tokens, 3 new tokens each."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab - 1, size=BT).tolist()
    return [(prefix + rng.randint(1, vocab - 1, size=t).tolist(), 3)
            for t in (1, 9, 5, 12, 3, 7)]


def share_jits(jsrv, jits):
    """Give a JAX engine the jitted step functions of the row's earlier
    engines (same model, same max_len: the same functions), so each shape
    compiles once per row rather than once per engine; the ones it adds
    are kept for the next."""
    for name, fn in jsrv.jit_fns().items():
        if name in jits:
            setattr(jsrv, "_" + name, jits[name])
        else:
            jits[name] = fn
    return jsrv


def _drained(srv):
    """Post-drain leak check: retained prefix pages are deliberate, so
    force-flush them first, then nothing may remain, near or far."""
    if srv.prefix_cache:
        srv.pager.evict_prefixes()
    kv = srv.kv_stats()
    far = kv["tier"]["far_resident"] if kv["tiered"] else 0
    return kv["paged"]["pages_in_use"] == 0 and far == 0


@pytest.fixture(scope="module", params=sorted(ROWS))
def row(request):
    jmodel, jparams, tmodel, tparams, max_len = _tiny_pair(request.param)
    trace = tier_trace(128, 4321 + ROWS[request.param][2])
    return (request.param, jmodel, jparams, tmodel, tparams, trace, max_len,
            {})


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tiered_engine_matches_jax(row, run):
    fam, jmodel, jparams, tmodel, tparams, trace, max_len, jits = row
    kw = dict(RUNS[run])
    if kw.get("kv_near_blocks") == "slot":
        kw["kv_near_blocks"] = blocks_for(max_len, BT)
    common = dict(batch_slots=3, max_len=max_len, nic_cost=None,
                  block_tokens=BT, **kw)
    jsrv = share_jits(JaxBatchServer(jmodel, params=jparams, **common), jits)
    tsrv = BatchServer(tmodel, params=tparams, device="cpu", **common)
    assert tsrv.tiered and jsrv.tiered
    assert "kv_migrate" in tsrv.jit_fns()
    assert tuple(tsrv.pages["kp"].shape[:2]) == \
        (2, tsrv.pager.near_frames + 1)
    assert tuple(tsrv.far_pages["kp"].shape[:2]) == \
        (2, tsrv.pager.far_frames + 1)
    for i, (p, m) in enumerate(trace):
        buf = encode_request(i, p, m)
        jsrv.submit_wire(buf)
        tsrv.submit_wire(buf)
    jout = jsrv.run_until_drained()
    tout = tsrv.run_until_drained()
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert sorted(tout) == sorted(jout)          # byte-identical responses
    assert len(tout) == len(trace) and tsrv.stats["failed"] == 0
    for key in ("prefills", "prefill_chunks", "decode_steps", "ticks",
                "admitted", "completed"):
        assert tsrv.stats[key] == jsrv.stats[key], key
    tkv, jkv = tsrv.kv_stats(), jsrv.kv_stats()
    assert tkv["tier"] == jkv["tier"]
    assert tkv == jkv
    tier = tkv["tier"]
    assert tier["demotions"] >= tier["promotions"]
    if run == "pressured":
        assert tier["near_frames"] == blocks_for(max_len, BT)
        assert tier["demotions"] > 0 and tier["promotions"] > 0
    if run == "demote-after":
        assert tsrv.pager.policy.demote_after == 1
    assert _drained(tsrv) and _drained(jsrv)


BAD_KNOBS = {
    "overcommit-below-1": dict(kv_overcommit=0.5),
    "overcommit-and-near": dict(kv_overcommit=2.0, kv_near_blocks=8),
    "dense-plane": dict(paged_kv=False, kv_overcommit=2.0),
    "demote-untiered": dict(kv_demote_after=2),
    "demote-zero": dict(kv_overcommit=2.0, kv_demote_after=0),
    "near-below-a-slot": dict(kv_near_blocks=1),
}


@pytest.mark.parametrize("name", sorted(BAD_KNOBS))
def test_knob_validation_as_jax(name):
    jcfg = jax_reduced(jax_get_config("mistral-nemo-12b")).replace(**TINY)
    tcfg = reduced(get_config("mistral-nemo-12b")).replace(**TINY)
    kw = BAD_KNOBS[name]
    with pytest.raises(ValueError) as jerr:
        JaxBatchServer(jax_build_model(jcfg), batch_slots=3, max_len=32,
                       nic_cost=None, **kw)
    with pytest.raises(ValueError) as terr:
        BatchServer(build_model(tcfg), batch_slots=3, max_len=32,
                    device="cpu", nic_cost=None, **kw)
    assert str(terr.value) == str(jerr.value)


# (demotion pairs, promotion pairs) of one event over a near arena of 5
# real frames and a far arena of 4, both full
MIGRATIONS = {
    "demotions": ([(0, 2), (3, 0), (4, 3)], []),
    "promotions": ([], [(1, 4), (2, 1)]),
    # near frame 2 is demoted into far frame 1 while far frame 1 is
    # promoted into near frame 2, and near 4 / far 3 likewise: a read
    # after either write would see the other tier's new page
    "swap": ([(2, 1), (4, 3), (0, 0)], [(1, 2), (3, 4), (2, 0)]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MIGRATIONS))
def test_kv_migrate_matches_jax(case, dtype):
    dem, pro = MIGRATIONS[case]
    rng = np.random.RandomState(17)
    L, bt, K, hd, n_near, n_far = 2, 4, 2, 8, 5, 4
    arenas = {name: {kv: rng.randn(L, n + 1, bt, K, hd).astype(np.float32)
                     for kv in ("kp", "vp")}
              for name, n in (("near", n_near), ("far", n_far))}
    m = 4

    def pad(pairs, trash_src, trash_dst):
        src = np.full((m,), trash_src, np.int32)
        dst = np.full((m,), trash_dst, np.int32)
        for i, (s, d) in enumerate(pairs):
            src[i], dst[i] = s, d
        return src, dst
    idx = (*pad(dem, n_near, n_far), *pad(pro, n_far, n_near))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jnear, jfar = jax_kv_migrate(
        {k: jnp.asarray(v, jdt) for k, v in arenas["near"].items()},
        {k: jnp.asarray(v, jdt) for k, v in arenas["far"].items()},
        *[jnp.asarray(i) for i in idx])
    # owned copies: the port migrates in place
    tnear, tfar = lm_kv_migrate(
        {k: torch.tensor(v, dtype=tdt) for k, v in arenas["near"].items()},
        {k: torch.tensor(v, dtype=tdt) for k, v in arenas["far"].items()},
        *[torch.from_numpy(i) for i in idx])
    for name, (t, j, n) in {"near": (tnear, jnear, n_near),
                            "far": (tfar, jfar, n_far)}.items():
        for kv in ("kp", "vp"):
            got = t[kv][:, :n].float().numpy()        # trash frame excluded
            exp = np.asarray(j[kv][:, :n].astype(jnp.float32))
            np.testing.assert_array_equal(got, exp, err_msg=f"{name} {kv}")
    # every destination holds its source's page as it was before the event
    for s, d in dem:
        np.testing.assert_array_equal(
            tfar["kp"][:, d].float().numpy(),
            torch.from_numpy(arenas["near"]["kp"][:, s]).to(tdt).float())
    for s, d in pro:
        np.testing.assert_array_equal(
            tnear["vp"][:, d].float().numpy(),
            torch.from_numpy(arenas["far"]["vp"][:, s]).to(tdt).float())


def _churn(pager, seed, n_ops=400):
    """A seeded sequence of tiered pager operations as the engine issues
    them; returns everything each operation reported, in order."""
    rng = np.random.RandomState(seed)
    log = []
    slots = {}                    # slot -> resident tokens
    tick = 0
    for _ in range(n_ops):
        op = rng.randint(5)
        bt = pager.block_tokens
        # allocations go through the engine's gate: never more new blocks
        # than the frames obtainable without touching pinned pages
        if op == 0 and len(slots) < pager.n_slots:
            free = [s for s in range(pager.n_slots) if s not in slots]
            slot = free[rng.randint(len(free))]
            tokens = int(rng.randint(1, pager.max_len // 2))
            if blocks_for(tokens, bt) <= pager.admit_headroom():
                log.append(("admit", slot, pager.admit(slot, tokens)))
                slots[slot] = tokens
        elif op == 1 and slots:
            slot = sorted(slots)[rng.randint(len(slots))]
            tokens = min(pager.max_len, slots[slot] + int(rng.randint(1, 20)))
            grow = blocks_for(tokens, bt) - pager.resident_blocks(slot)
            if grow <= pager.admit_headroom():
                log.append(("advance", slot, pager.advance(slot, tokens)))
                slots[slot] = tokens
        elif op == 2 and slots:
            slot = sorted(slots)[rng.randint(len(slots))]
            pager.release(slot)
            del slots[slot]
            log.append(("release", slot))
        elif op == 3:
            tick += 1
            pager.begin_tick(tick)
            order = sorted(slots)
            rng.shuffle(order)
            engaged = pager.engage([(s, min(pager.max_len, slots[s] + 1))
                                    for s in order])
            pro = pager.plan_near_slots(engaged,
                                        prefetch=bool(rng.randint(2)))
            log.append(("engage", engaged, pro))
        else:
            log.append(("headroom", pager.admit_headroom()))
        log.append(("migrations", pager.take_migrations()))
        if slots and op == 3:
            rows = pager.block_table()[engaged]
            log.append(("to_near", pager.to_near(rows).tolist()))
        log.append(("stats", pager.stats()))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_pager_copy_churns_as_jax(seed):
    kw = dict(n_slots=4, max_len=64, block_tokens=8, paged=True,
              track_table=True, footprint=(256, 0), near_frames=10)
    jlog = _churn(JaxPager(None, **kw), seed)
    tlog = _churn(KVBlockPager(None, **kw), seed)
    assert len(tlog) == len(jlog)
    for t, j in zip(tlog, jlog):
        assert repr(t) == repr(j)
    kinds = {e[0] for e in tlog}
    assert {"admit", "advance", "release", "engage", "to_near"} <= kinds
    migrated = [e for e in tlog if e[0] == "migrations" and e[1]]
    assert any(dem for ev in migrated for dem, _ in ev[1])
    assert any(pro for ev in migrated for _, pro in ev[1])
