"""The port's dense-cache plane of the dense and moe families against the
JAX reference (``paged_kv=False``): the (slots, max_len) KV cache with
bucketed or exact-length prefill, and under a sliding window the ring of
window rows (``cache["pos"]``).

Model level, on tiny configs (the ``_tiny`` overrides of
``tests/test_differential.py``) at f32 with params bridged from JAX's
``Model.init``: ``lm_init_cache``, ``lm_prefill`` with ``max_len`` (and
with ``valid_len`` on right-padded tokens), then three ``lm_decode_step``
calls, leaf by leaf (``k``, ``v``, ``cur``, ``pos``) and at the logits,
within 1e-5: mistral-nemo, granite-moe under dropless and capacity
routing, and h2o-danube (window 16) with S < W, S = W and S > W.  The
``valid_len`` refusals equal JAX's.

Engine level: the ``dense-bucketed``, ``dense-bucketed-pfb4``,
``dense-exact``, ``moe-dense`` and ``dense-ring`` rows of
``tests/test_differential.py`` and the async ``dense-bucketed`` row,
through the port's ``BatchServer`` and the JAX one on the same params:
greedy tokens, scheduler counts and the whole ``kv_stats()`` equal.  Also
the ``dense_buckets`` ladders, the engine's callables, JAX's refusals on
this plane, the splice's handling of the ring positions and the launcher's
``--no-paged-kv``.
"""
import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import rpc as jwire
from repro.models.model import build_model as jax_build_model
from repro.runtime.server import AsyncBatchServer as JaxAsyncBatchServer
from repro.runtime.server import BatchServer as JaxBatchServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.runtime.server import (
    AsyncBatchServer, BatchServer, _splice_rows_tree, encode_request,
)

# the _tiny overrides of tests/test_differential.py, at f32
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, param_dtype="float32",
            cache_dtype="float32")
TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 32
# row -> (arch, config overrides, params key)
ROWS = {
    "dense": ("mistral-nemo-12b", {}, 3),
    "moe-dropless": ("granite-moe-3b-a800m", dict(moe_routing="dropless"),
                     2),
    "moe-capacity": ("granite-moe-3b-a800m", dict(moe_routing="capacity"),
                     2),
    "swa": ("h2o-danube-3-4b", {}, 5),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


def _pair(row):
    """JAX model + params and the port's model + bridged params."""
    arch, over, key = ROWS[row]
    jcfg = jax_reduced(jax_get_config(arch)).replace(**TINY, **over)
    tcfg = reduced(get_config(arch)).replace(**TINY, **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(key))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                torch.float32)
    return jmodel, jparams, build_model(tcfg), tparams


@functools.lru_cache(maxsize=None)
def pair(row):
    """``_pair(row)``, built once per row for the whole file."""
    return _pair(row)


def _assert_cache(tc, jc):
    assert sorted(tc) == sorted(jc)
    for name in sorted(jc):
        got, exp = tc[name], np.asarray(jc[name])
        assert tuple(got.shape) == exp.shape, name
        if name in ("cur", "pos"):
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(got.numpy(), exp, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), exp, err_msg=name,
                                       **TOL)


# ------------------------------------------------------------ model level
# (row, S, max_len, bucket): bucket pads the S tokens to that length and
# passes valid_len = S
STEPS = {
    "dense-exact": ("dense", 13, MAX_LEN, None),
    "dense-bucketed": ("dense", 11, MAX_LEN, 16),
    "moe-dropless-exact": ("moe-dropless", 13, MAX_LEN, None),
    "moe-dropless-bucketed": ("moe-dropless", 9, MAX_LEN, 16),
    "moe-capacity-exact": ("moe-capacity", 13, MAX_LEN, None),
    "swa-S<W": ("swa", 9, 48, None),
    "swa-S=W": ("swa", 16, 48, None),
    "swa-S>W": ("swa", 37, 48, None),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_prefill_and_decode_steps_match_jax(name):
    """lm_init_cache's tree, then lm_prefill (B = 2) with max_len (and
    valid_len), then three lm_decode_steps, each leaf by leaf."""
    row, S, max_len, bucket = STEPS[name]
    jmodel, jparams, tmodel, tparams = pair(row)
    ji = jmodel.init_cache(2, max_len)
    ti = tmodel.init_cache(2, max_len, device="cpu")
    _assert_cache(ti, ji)
    rng = np.random.RandomState(S)
    toks = rng.randint(1, 127, size=(2, S)).astype(np.int32)
    if bucket is None:
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, None,
                                max_len)
        tl, tc = tmodel.prefill(tparams, _t(toks), max_len)
    else:
        padded = np.pad(toks, ((0, 0), (0, bucket - S)))
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(padded)},
                                None, max_len, jnp.asarray(S, jnp.int32))
        tl, tc = tmodel.prefill(tparams, _t(padded), max_len, S)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache(tc, jc)
    assert int(tc["cur"]) == S
    for step in range(3):
        last = rng.randint(1, 127, size=(2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(last))
        tl, tc = tmodel.decode_step(tparams, tc, _t(last))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=name,
                                   **TOL)
        _assert_cache(tc, jc)
        assert int(tc["cur"]) == S + step + 1
    if row == "swa":
        # the ring invariant: row i holds the position p with p % T == i
        # among the last T positions written, -1 where none reached it
        T = tc["pos"].shape[0]
        cur = int(tc["cur"])
        want = np.full((T,), -1)
        for p in range(max(0, cur - T), cur):
            want[p % T] = p
        np.testing.assert_array_equal(tc["pos"].numpy(), want)


@pytest.mark.parametrize("row", ["swa", "moe-capacity", "hybrid"])
def test_valid_len_refusals_equal_jax(row):
    """Bucketed prefill under a window, capacity routing or recurrent
    state raises JAX's ValueError, word for word."""
    if row == "hybrid":
        jcfg = jax_reduced(jax_get_config("zamba2-7b")).replace(
            **dict(TINY, n_layers=5))
        tcfg = reduced(get_config("zamba2-7b")).replace(
            **dict(TINY, n_layers=5))
        jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
        jparams = tparams = None
    else:
        jmodel, jparams, tmodel, tparams = pair(row)
    toks = np.ones((1, 8), np.int32)
    with pytest.raises(ValueError, match="valid_len") as jerr:
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, None, 16,
                       jnp.asarray(5, jnp.int32))
    with pytest.raises(ValueError, match="valid_len") as terr:
        tmodel.prefill(tparams, _t(toks), 16, 5)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ engine level
def _trace(vocab=128):
    """The differential trace: ragged lengths incl. single-token and
    max-capacity prompts, max_new incl. 1."""
    rng = np.random.RandomState(4321)
    lens_new = [(4, 4), (9, 1), (16, 3), (1, 5), (27, 4), (5, 2), (13, 3)]
    return [(rng.randint(1, vocab - 1, size=n).tolist(), m)
            for n, m in lens_new]


def _swa_trace():
    """TestSlidingWindowDifferential's trace: W/2, W, W+5, 2W+3, 3."""
    rng = np.random.RandomState(4321)
    return [(rng.randint(1, 127, size=n).tolist(), 4)
            for n in (8, 16, 21, 35, 3)]


# engine row -> (model row, server options, max_len)
ENGINES = {
    "dense-bucketed": ("dense", dict(paged_kv=False), MAX_LEN),
    "dense-bucketed-pfb4": ("dense", dict(paged_kv=False, prefill_batch=4),
                            MAX_LEN),
    "dense-exact": ("dense", dict(paged_kv=False, prefill_chunk=0), MAX_LEN),
    "moe-dense": ("moe-dropless", dict(paged_kv=False), MAX_LEN),
    "dense-ring": ("swa", dict(paged_kv=False), 48),
}


def _drive_sync(srv, trace):
    for i, (p, m) in enumerate(trace):
        srv.submit_wire(encode_request(i, p, m))
    return srv.run_until_drained()


def _drive_async(srv, trace):
    async def go():
        eng = asyncio.ensure_future(srv.run_engine())
        outs = await asyncio.gather(
            *[srv.submit_async(encode_request(i, p, m))
              for i, (p, m) in enumerate(trace)])
        srv.close()
        await eng
        return outs
    return asyncio.run(go())


COUNTS = ("prefills", "prefill_chunks", "decode_steps", "completed",
          "failed", "admitted", "ticks", "decode_tokens")


@pytest.mark.parametrize("name", sorted(ENGINES) + ["async-dense-bucketed"])
def test_dense_plane_engine_matches_jax(name):
    asynchronous = name.startswith("async-")
    row, kw, max_len = ENGINES[name.removeprefix("async-")]
    jmodel, jparams, tmodel, tparams = pair(row)
    trace = _swa_trace() if row == "swa" else _trace()
    jcls = JaxAsyncBatchServer if asynchronous else JaxBatchServer
    tcls = AsyncBatchServer if asynchronous else BatchServer
    jsrv = jcls(jmodel, batch_slots=3, max_len=max_len, params=jparams,
                nic_cost=None, **kw)
    tsrv = tcls(tmodel, batch_slots=3, max_len=max_len, params=tparams,
                device="cpu", nic_cost=None, **kw)
    assert not tsrv.paged and tsrv.dense_buckets == jsrv.dense_buckets
    drive = _drive_async if asynchronous else _drive_sync
    jout, tout = drive(jsrv, trace), drive(tsrv, trace)
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert len(tout) == len(trace)
    assert {k: tsrv.stats[k] for k in COUNTS} == \
        {k: jsrv.stats[k] for k in COUNTS}
    assert tsrv.kv_stats() == jsrv.kv_stats()
    assert tsrv.kv_stats()["paged_kv"] is False
    st = tsrv.kv_stats()
    assert st["blocks_allocated"] == st["blocks_freed"], "leaked blocks"
    if row == "swa":
        assert "pos" in tsrv.cache and tsrv.dense_buckets == ()
    assert sorted(tsrv.jit_fns()) == sorted(jsrv.jit_fns())


@pytest.mark.parametrize("max_len,buckets", [
    (72, 4), (32, 4), (512, 4), (8448, 4), (16, 1), (100, 9), (7, 4)])
def test_dense_bucket_ladder_equals_jax(max_len, buckets):
    """The full geometric ladder from max_len down to the 8-token floor;
    (9, 18, 36, 72) at max_len 72 with prefill_buckets=4."""
    jmodel, jparams, tmodel, tparams = pair("dense")
    jsrv = JaxBatchServer(jmodel, batch_slots=2, max_len=max_len,
                          params=jparams, nic_cost=None, paged_kv=False,
                          prefill_buckets=buckets)
    tsrv = BatchServer(tmodel, batch_slots=2, max_len=max_len,
                       params=tparams, device="cpu", nic_cost=None,
                       paged_kv=False, prefill_buckets=buckets)
    assert tsrv.dense_buckets == jsrv.dense_buckets
    if max_len == 72:
        assert tsrv.dense_buckets == (9, 18, 36, 72)


# JAX's refusals on the dense plane (TestEngineConfigValidation and the
# bucket knob): each a ValueError in both packages
BAD = {
    "prefix-cache": (dict(prefix_cache=True), "paged"),
    "chunk": (dict(prefill_chunk=8), "paged"),
    "zero-buckets": (dict(prefill_buckets=0), "prefill_buckets"),
    "tiering": (dict(kv_overcommit=2.0), "paged"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_dense_plane_refusals_equal_jax(name):
    jmodel, jparams, tmodel, tparams = pair("dense")
    kw, words = BAD[name]
    with pytest.raises(ValueError, match=words) as jerr:
        JaxBatchServer(jmodel, batch_slots=2, max_len=16, params=jparams,
                       nic_cost=None, paged_kv=False, **kw)
    with pytest.raises(ValueError, match=words) as terr:
        BatchServer(tmodel, batch_slots=2, max_len=16, params=tparams,
                    device="cpu", nic_cost=None, paged_kv=False, **kw)
    assert str(terr.value) == str(jerr.value)


def test_splice_never_takes_the_ring_positions_for_a_batch_leaf():
    """A (T,) pos leaf whose T equals the group size and the slot count is
    not spliced: the engine installs the shared ring itself."""
    cache = {"k": torch.zeros((1, 4, 4, 1, 2)),
             "pos": torch.full((4,), -1, dtype=torch.int32),
             "cur": torch.zeros((), dtype=torch.int32)}
    one = {"k": torch.ones((1, 4, 4, 1, 2)),
           "pos": torch.arange(4, dtype=torch.int32),
           "cur": torch.full((), 4, dtype=torch.int32)}
    _splice_rows_tree(cache, one, torch.arange(4), 4)
    assert bool((cache["k"] == 1).all())
    assert cache["pos"].tolist() == [-1] * 4 and int(cache["cur"]) == 0


@pytest.mark.parametrize("arch,extra", [
    ("mistral-nemo-12b", []),
    ("granite-moe-3b-a800m", []),
    ("h2o-danube-3-4b", ["--prompt-len", "40"]),
], ids=["dense", "moe", "swa"])
def test_launcher_serves_the_dense_plane_on_cpu(arch, extra, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--max-new", "3", "--no-paged-kv",
                      *extra])
    assert len(out) == 3
    text = capsys.readouterr().out
    assert "3/3 completed" in text and "kv: dense cache" in text


def test_launcher_refuses_chunking_on_the_dense_plane(capsys):
    with pytest.raises(SystemExit) as ex:
        serve.main(["--device", "cpu", "--no-paged-kv", "--prefill-chunk",
                    "8"])
    assert ex.value.code == 2
    assert "--prefill-chunk requires the paged KV plane" in \
        capsys.readouterr().err
