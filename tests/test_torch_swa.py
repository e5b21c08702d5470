"""The port's paged sliding-window plane against the JAX reference, on a
tiny h2o-danube-3-4b (window W = 16, as ``tests/test_differential.py``
builds it): the ``BatchServer`` chunked (auto and chunk 8) and one-shot on
the differential trace (W/2, W, W+5, 2W+3, 3 tokens), with greedy tokens
and ``kv_stats()`` equal to the JAX engine's; the O(window) footprint;
``lm_prefill``'s ring-packed cache and ``lm_paged_prefill_write``'s ring
rows leaf by leaf; one decode step over a table whose leading entries
``release_behind`` set to -1; and the alignment of every released block
with the decode kernel's first live position.

All at f32 on params bridged from JAX's ``Model.init``.  Tolerances: the
model steps within 1e-4 (matmuls sum in torch's order, not XLA's), the
page writes exact, the engines' tokens and accounting identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import rpc as jwire
from repro.models import transformer as jtr
from repro.models.model import build_model as jax_build_model
from repro.runtime.scheduler import Request as JaxRequest
from repro.runtime.server import BatchServer as JaxBatchServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.launch import serve
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.runtime.scheduler import (
    KVBlockPager, Request, RequestState, blocks_for,
)
from repro_torch.runtime.server import BatchServer, encode_request

ARCH = "h2o-danube-3-4b"
# the _tiny overrides of tests/test_differential.py, at f32
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, param_dtype="float32",
            cache_dtype="float32")
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
jax_prefill = jax.jit(lambda p, cfg, t: jtr.lm_prefill(p, cfg, {"tokens": t}),
                      static_argnums=(1,))
jax_write = jax.jit(jtr.lm_paged_prefill_write, static_argnums=(0, 5, 6))
jax_decode = jax.jit(jtr.lm_paged_decode_step, static_argnums=(1,))


def _configs():
    return (jax_reduced(jax_get_config(ARCH)).replace(**TINY),
            reduced(get_config(ARCH)).replace(**TINY))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


@pytest.fixture(scope="module")
def danube():
    jcfg, tcfg = _configs()
    assert jcfg.sliding_window == tcfg.sliding_window == 16
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                torch.float32)
    return jmodel, jparams, build_model(tcfg), tparams


def test_config_is_jax_s():
    jcfg = jax_get_config(ARCH)
    tcfg = get_config(ARCH)
    assert tcfg == tcfg.replace(**{f: getattr(jcfg, f)
                                   for f in jcfg.__dataclass_fields__})
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.head_dim, tcfg.d_ff, tcfg.vocab, tcfg.sliding_window) == \
        (24, 3840, 32, 8, 120, 10240, 32000, 4096)
    assert reduced(tcfg).sliding_window == 16


# ------------------------------------------------------------ engine
class TestSlidingWindowEngine:
    """The auto-chunked, chunk8 and oneshot rows of
    ``TestSlidingWindowDifferential``, port against the JAX engine."""

    PLANES = {"auto-chunked": dict(), "chunk8": dict(prefill_chunk=8),
              "oneshot": dict(prefill_chunk=0)}

    @pytest.fixture(scope="class")
    def trace(self, danube):
        W = danube[0].cfg.sliding_window
        rng = np.random.RandomState(4321)
        lens = (W // 2, W, W + 5, 2 * W + 3, 3)
        return [(rng.randint(1, 127, size=n).tolist(), 4) for n in lens], \
            2 * W + 16

    @pytest.mark.parametrize("plane", sorted(PLANES))
    def test_swa_plane_matches_jax(self, danube, trace, plane):
        jmodel, jparams, tmodel, tparams = danube
        reqs, max_len = trace
        kw = self.PLANES[plane]
        jsrv = JaxBatchServer(jmodel, batch_slots=3, max_len=max_len,
                              params=jparams, nic_cost=None, **kw)
        tsrv = BatchServer(tmodel, batch_slots=3, max_len=max_len,
                           params=tparams, device="cpu", nic_cost=None, **kw)
        assert tsrv.paged and tsrv.window == jsrv.window == 16
        assert tsrv.prefill_chunk == jsrv.prefill_chunk
        for i, (p, m) in enumerate(reqs):
            buf = encode_request(i, p, m)
            jsrv.submit_wire(buf)
            tsrv.submit_wire(buf)
        jout = jsrv.run_until_drained()
        tout = tsrv.run_until_drained()
        assert _outs(tout, wire) == _outs(jout, jwire)
        assert sorted(tout) == sorted(jout)      # byte-identical responses
        assert len(tout) == len(reqs) and tsrv.stats["failed"] == 0
        for key in ("prefills", "prefill_chunks", "decode_steps",
                    "completed", "admitted", "ticks", "decode_tokens"):
            assert tsrv.stats[key] == jsrv.stats[key], key
        assert tsrv.kv_stats() == jsrv.kv_stats()
        assert tsrv.kv_stats()["paged"]["pages_in_use"] == 0, "leaked pages"
        # the window released blocks before the drain did
        assert tsrv.kv_stats()["blocks_allocated"] > 0

    def test_swa_steady_state_footprint_is_O_window(self, danube):
        """Partial release keeps the slot's resident blocks within the
        window (+1 boundary block +1 never-freed tail block) while its
        position grows far past it; tokens and accounting as JAX's."""
        jmodel, jparams, tmodel, tparams = danube
        W, bt = 16, 8
        max_len = 2 * W + 16
        prompt = np.random.RandomState(7).randint(1, 127,
                                                  size=2 * W + 3).tolist()
        max_new = max_len - len(prompt) - 1
        bound = -(-W // bt) + 2
        peaks = []
        srvs = []
        for cls, req_cls, extra in (
                (BatchServer, Request, dict(params=tparams, device="cpu")),
                (JaxBatchServer, JaxRequest, dict(params=jparams))):
            srv = cls(tmodel if cls is BatchServer else jmodel,
                      batch_slots=2, max_len=max_len, nic_cost=None,
                      block_tokens=bt, prefill_chunk=8, **extra)
            srv.submit(req_cls(0, prompt, max_new))
            peak = 0
            while srv.active or len(srv.queue):
                srv.step()
                if 0 in srv.active and \
                        srv.active[0].state.name == RequestState.DECODE.name:
                    peak = max(peak, srv.pager.resident_blocks(0))
            peaks.append(peak)
            srvs.append(srv)
        tsrv, jsrv = srvs
        assert 0 < peaks[0] <= bound, (peaks, bound)
        assert peaks[0] == peaks[1]
        st = tsrv.kv_stats()
        assert st["blocks_allocated"] > bound
        assert st["blocks_allocated"] == st["blocks_freed"]
        assert st == jsrv.kv_stats()
        assert tsrv.completed_reqs[0].generated == \
            jsrv.completed_reqs[0].generated


# ------------------------------------------------------------ model steps
@pytest.mark.parametrize("S", [9, 16, 37], ids=["S<W", "S=W", "S>W"])
def test_lm_prefill_ring_matches_jax(danube, S):
    """k, v in ring order, pos and cur, leaf by leaf, and the logits."""
    jmodel, jparams, tmodel, tparams = danube
    toks = np.random.RandomState(S).randint(
        1, 127, size=(2, S)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jmodel.cfg, jnp.asarray(toks))
    tl, tc = tmodel.prefill(tparams, _t(toks))
    assert sorted(tc) == sorted(jc) == ["cur", "k", "pos", "v"]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    T = min(16, S)
    for k in ("k", "v"):
        assert tc[k].shape == jc[k].shape == (2, 2, T, 2, 16)
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **STEP_TOL)
    assert tc["pos"].dtype == torch.int32
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(tc["cur"]) == int(jc["cur"]) == S


@pytest.mark.parametrize("S", [13, 16, 21, 35],
                         ids=["W-3", "W", "W+5", "2W+3"])
def test_paged_prefill_write_ring_rows_match_jax(S):
    """Ring rows (T = min(W, S)) of a G = 2 group: unpermuted, placed at
    [S - T, S) with zeros before; every page but the trash page P - 1
    equal to JAX's."""
    jcfg, tcfg = _configs()
    rng = np.random.RandomState(S)
    L, G, K, hd, bt = 2, 2, 2, 16, 8
    T = min(16, S)
    nb = -(-S // bt)
    P = G * nb + 3
    k_rows = rng.randn(L, G, T, K, hd).astype(np.float32)
    v_rows = rng.randn(L, G, T, K, hd).astype(np.float32)
    ids = rng.permutation(P - 1)[:G * nb].astype(np.int32)
    kp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    vp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    jpages = jax_write(jcfg, {"kp": jnp.asarray(kp0), "vp": jnp.asarray(vp0)},
                       jnp.asarray(k_rows), jnp.asarray(v_rows),
                       jnp.asarray(ids), S, 0)
    tpages = {"kp": _t(kp0).clone(), "vp": _t(vp0).clone()}
    out = ttr.lm_paged_prefill_write(tcfg, tpages, _t(k_rows), _t(v_rows),
                                     _t(ids), S)
    assert out["kp"] is tpages["kp"], "arena must update in place"
    for k in ("kp", "vp"):
        np.testing.assert_array_equal(tpages[k].numpy()[:, :P - 1],
                                      np.asarray(jpages[k])[:, :P - 1])
    # position p of slot 0 holds ring row p % T for p >= S - T, else zero
    got = tpages["kp"].numpy()[:, ids[:nb]].reshape(L, nb * bt, K, hd)
    for p in range(S):
        exp = k_rows[:, 0, p % T] if p >= S - T else 0.0
        np.testing.assert_array_equal(got[:, p], np.broadcast_to(
            exp, got[:, p].shape))


def _released_table(W, bt, nb, lens):
    """A block table as the engine leaves it at a decode tick: each slot's
    blocks allocated through the pager, then ``release_behind(slot, pos -
    W)`` with pos = lens + 1, as ``_decode_tick`` calls it."""
    B = len(lens)
    pager = KVBlockPager(None, n_slots=B, max_len=nb * bt, block_tokens=bt,
                         paged=True, track_table=True, footprint=(64, 0))
    for slot, n in enumerate(lens):
        pager.admit(slot, 0)
        pager.advance(slot, n + 1)
        pager.release_behind(slot, max(0, n + 1 - W))
    return np.array(pager.block_table(nb)), pager


@pytest.mark.parametrize("lens", [(40, 17, 25, 0), (47, 33, 16, 63)],
                         ids=["mid-block", "block-edges"])
def test_decode_step_over_released_blocks_matches_jax(danube, lens):
    """One paged decode step of slots whose leading table entries
    ``release_behind`` set to -1 (the kernels clamp them to page 0 without
    a mask): logits and the arena equal JAX's."""
    jmodel, jparams, tmodel, tparams = danube
    W, bt, nb = 16, 8, 8
    btab, _ = _released_table(W, bt, nb, lens)
    assert (btab[:, 0] < 0).sum() >= 2, btab
    rng = np.random.RandomState(sum(lens))
    L, K, hd = 2, 2, 16
    P = len(lens) * nb + 1
    kp = rng.randn(L, P, bt, K, hd).astype(np.float32)
    vp = rng.randn(L, P, bt, K, hd).astype(np.float32)
    # a released page is garbage to the reader: poison page 0, where the
    # kernels clamp -1 entries, so a read of it would show
    kp[:, 0] = 1e4
    vp[:, 0] = -1e4
    toks = rng.randint(1, 127, size=(len(lens), 1)).astype(np.int32)
    ln = np.asarray(lens, np.int32)
    jl, jp = jax_decode(jparams, jmodel.cfg,
                        {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)},
                        jnp.asarray(toks), jnp.asarray(btab),
                        jnp.asarray(ln))
    tp = {"kp": _t(kp).clone(), "vp": _t(vp).clone()}
    tl, _ = tmodel.paged_decode_step(tparams, tp, _t(toks), _t(btab),
                                     _t(ln))
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tp[k].numpy()[:, :P - 1],
                                   np.asarray(jp[k])[:, :P - 1], **STEP_TOL)


@pytest.mark.parametrize("W,bt", [(16, 8), (16, 16), (16, 5), (100, 16),
                                  (4096, 16)])
def test_released_blocks_lie_behind_the_decode_window(W, bt):
    """The decode kernel reads positions [lens - W + 1, lens) and clamps
    -1 entries there to page 0 unmasked, so ``release_behind(slot, pos -
    W)`` must never free a block that reaches position lens - W + 1 (the
    chunked plane's ``release_behind(slot, prefilled - W + 1)`` is the
    same bound for the next chunk's first live key); and it frees every
    block wholly behind it but the slot's last (O(window) footprint)."""
    nb = blocks_for(3 * W + 1, bt)
    ns = range(3 * W + 1) if W <= 100 else sorted(
        {W + d + k * bt for k in (0, 1, 100) for d in (-2, -1, 0, 1, 2)}
        | {0, 2 * W + 3, 3 * W})
    for n in ns:
        btab, pager = _released_table(W, bt, nb, [n])
        lo = max(0, n - W + 1)
        owned = blocks_for(n + 1, bt)
        freed = np.flatnonzero(btab[0, :owned] < 0)
        assert all((j + 1) * bt <= lo for j in freed), (n, freed, lo)
        assert len(freed) == min(lo // bt, owned - 1), (n, freed)
        assert pager.resident_blocks(0) == owned - len(freed)


def test_launcher_serves_danube_on_cpu(capsys):
    for extra in ([], ["--prefill-chunk", "0"]):
        out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                          "3", "--slots", "2", "--prompt-len", "37",
                          "--max-new", "3", *extra])
        assert len(out) == 3
        assert "3/3 completed" in capsys.readouterr().out
