"""The port's xLSTM slice (the ssm family: mLSTM and sLSTM blocks, served
with continuous admission on the dense-cache plane) against the JAX
reference.

Inputs come from fixed numpy seeds, params from JAX's ``Model.init``
bridged leaf by leaf (``params_from_numpy``).  Tolerances: at f32 every
block, step and state leaf within 1e-4 (matmuls and cumulative sums run
in torch's order, not XLA's); in bf16 normwise within 2e-2 (the largest
difference within 2e-2 of the largest magnitude).  The engines' greedy
tokens, scheduler counts and the whole ``kv_stats()`` equal JAX's: the
staggered trace of ``TestContinuousBatchingExact`` (admissions between
decode ticks), at ``batch_slots == n_heads`` too, where the reference's
pager would count an mLSTM state as per-token bytes if the cache were
taken for a KV stack; a request past ``max_len``; the async engine.  The
refusals are JAX's, word for word.
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
from repro.models import transformer as jtr
from repro.models import xlstm as jxl
from repro.models.layers import init_params as jax_init_params
from repro.models.model import build_model as jax_build_model
from repro.runtime.scheduler import Request as JaxRequest
from repro.runtime.server import AsyncBatchServer as JaxAsyncBatchServer
from repro.runtime.server import BatchServer as JaxBatchServer
from repro.runtime.server import DisaggEngine as JaxDisaggEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.launch import serve
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as txl
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import schema_leaves
from repro_torch.models.model import build_model
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import (
    AsyncBatchServer, BatchServer, DisaggEngine, encode_request,
)

ARCH = "xlstm-125m"
F32 = dict(param_dtype="float32", cache_dtype="float32")
BF16 = dict(param_dtype="bfloat16", cache_dtype="bfloat16")
# TestContinuousBatchingExact's config: an mLSTM and an sLSTM layer
TINY = dict(n_layers=2, d_model=32, n_heads=2, head_dim=8, vocab=128)
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2


def _configs(dtypes=F32, **over):
    over = dict(dtypes, **over)
    return (jax_reduced(jax_get_config(ARCH)).replace(**over),
            reduced(get_config(ARCH)).replace(**over))


def _bridge(jparams, dtype=torch.float32):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", dtype)


def _t(a):
    """numpy/JAX array -> CPU tensor (bf16 arrays through f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_close(got, exp, name=""):
    np.testing.assert_allclose(_f32(got), _f32(exp), err_msg=name, **TOL)


def _assert_bf16_close(got, exp, name=""):
    got, exp = _f32(got), _f32(exp)
    assert got.shape == exp.shape
    err = float(np.abs(got - exp).max())
    assert err <= BF16_TOL * float(np.abs(exp).max()), \
        (name, err, float(np.abs(exp).max()))


def _assert_tree(got, exp, check=_assert_close, path=""):
    """The same nested dict, leaf by leaf: shapes and dtypes equal, values
    by ``check``; the int32 write index exactly."""
    assert sorted(got) == sorted(exp), path
    for name in exp:
        g, e = got[name], exp[name]
        key = f"{path}/{name}"
        if isinstance(e, dict):
            _assert_tree(g, e, check, key)
            continue
        e = np.asarray(e)
        assert tuple(g.shape) == e.shape, key
        assert str(g.dtype).split(".")[-1] == e.dtype.name, key
        if name == "cur":
            assert int(g) == int(e), key
        else:
            check(g, e, key)


def _block_params(kind, seed, jcfg, dtype=jnp.float32):
    schema = jxl.slstm_schema(jcfg) if kind == "slstm" \
        else jxl.mlstm_schema(jcfg)
    return jax_init_params(schema, jax.random.PRNGKey(seed), dtype)


def _state(kind, rng, B, jcfg):
    """A random incoming state: finite stabilisers, O(1) memories."""
    H, hd = jcfg.n_heads, jcfg.head_dim
    if kind == "mlstm":
        return {"C": rng.randn(B, H, hd, hd).astype(np.float32) * 0.3,
                "n": rng.randn(B, H, hd).astype(np.float32) * 0.3,
                "m": rng.randn(B, H).astype(np.float32)}
    return {k: rng.randn(B, H, hd).astype(np.float32) * 0.5
            for k in ("c", "n", "h", "m")}


jax_mlstm = jax.jit(jxl.mlstm_apply, static_argnums=(2,))
jax_slstm = jax.jit(jxl.slstm_apply, static_argnums=(2,))
jax_mlstm_step = jax.jit(jxl.mlstm_decode_step, static_argnums=(3,))
jax_slstm_step = jax.jit(jxl.slstm_decode_step, static_argnums=(3,))


# ------------------------------------------------------------ blocks
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("L", [5, 128, 150])
def test_mlstm_apply_matches_jax(L, with_state):
    """One chunk short, exactly one and two (the pad rows of the second
    keep the final state): output and (C, n, m) within 1e-4 at f32."""
    jcfg, tcfg = _configs()
    jp = _block_params("mlstm", L, jcfg)
    rng = np.random.RandomState(L)
    x = rng.randn(2, L, jcfg.d_model).astype(np.float32)
    st = _state("mlstm", rng, 2, jcfg) if with_state else None
    jy, jst = jax_mlstm(jp, jnp.asarray(x), jcfg,
                        None if st is None else jax.tree.map(jnp.asarray, st))
    ty, tst = txl.mlstm_apply(_bridge(jp), _t(x), tcfg,
                              None if st is None else
                              {k: _t(v) for k, v in st.items()})
    _assert_close(ty, jy, "y")
    _assert_tree(tst, jst)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_slstm_apply_matches_jax(with_state):
    jcfg, tcfg = _configs()
    jp = _block_params("slstm", 4, jcfg)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 13, jcfg.d_model).astype(np.float32)
    st = _state("slstm", rng, 2, jcfg) if with_state else None
    jy, jst = jax_slstm(jp, jnp.asarray(x), jcfg,
                        None if st is None else jax.tree.map(jnp.asarray, st))
    ty, tst = txl.slstm_apply(_bridge(jp), _t(x), tcfg,
                              None if st is None else
                              {k: _t(v) for k, v in st.items()})
    _assert_close(ty, jy, "y")
    _assert_tree(tst, jst)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_jax(kind):
    """Three recurrent steps from a random state, each from JAX's state
    of the step before."""
    jcfg, tcfg = _configs()
    jp = _block_params(kind, 5, jcfg)
    tp = _bridge(jp)
    rng = np.random.RandomState(21)
    st = jax.tree.map(jnp.asarray, _state(kind, rng, 3, jcfg))
    jstep = jax_mlstm_step if kind == "mlstm" else jax_slstm_step
    tstep = txl.mlstm_decode_step if kind == "mlstm" \
        else txl.slstm_decode_step
    for _ in range(3):
        x = rng.randn(3, 1, jcfg.d_model).astype(np.float32)
        jy, jst = jstep(jp, jnp.asarray(x), st, jcfg)
        ty, tst = tstep(tp, _t(x), {k: _t(v) for k, v in st.items()}, tcfg)
        _assert_close(ty, jy, "y")
        _assert_tree(tst, jst)
        st = jst


@pytest.mark.parametrize("kind,L", [("mlstm", 150), ("slstm", 13)])
def test_bf16_blocks_normwise(kind, L):
    """bf16 params and input: the block's output and final state within
    2e-2 normwise of JAX's (the k projection is f32 in both: JAX divides
    it by a numpy f64 scalar)."""
    jcfg, tcfg = _configs(BF16)
    jp = _block_params(kind, 7, jcfg, jnp.bfloat16)
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, L, jcfg.d_model), jnp.bfloat16)
    jfn = jax_mlstm if kind == "mlstm" else jax_slstm
    tfn = txl.mlstm_apply if kind == "mlstm" else txl.slstm_apply
    jy, jst = jfn(jp, x, jcfg)
    ty, tst = tfn(_bridge(jp, torch.bfloat16), _t(x), tcfg)
    assert ty.dtype == torch.bfloat16
    _assert_bf16_close(ty, jy)
    _assert_tree(tst, jst, _assert_bf16_close)


# ------------------------------------------------------------ model
@functools.lru_cache(maxsize=None)
def pair(name="reduced"):
    """(JAX model, JAX params, port model, bridged params) at f32."""
    jcfg, tcfg = _configs(**(TINY if name == "tiny" else {}))
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    return jmodel, jparams, build_model(tcfg), _bridge(jparams)


def test_schema_and_bridge_carry_the_ssm_tree():
    """Same leaf names (``layers/lNN`` with the kind marker), shapes and
    init kinds as JAX's schema; the bridge copies every leaf."""
    jcfg, tcfg = _configs()
    jflat = jax.tree_util.tree_flatten_with_path(
        jtr.lm_schema(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    jleaves = {"/".join(str(k.key) for k in path):
               (tuple(p.shape), p.init, p.scale) for path, p in jflat}
    tleaves = {path: (tuple(p.shape), p.init, p.scale)
               for path, p in schema_leaves(ttr.lm_schema(tcfg))}
    assert tleaves == jleaves
    assert "layers/l01/kind_slstm" in tleaves and \
        "layers/l00/kind_mlstm" in tleaves
    _, jparams, tmodel, tparams = pair()
    assert tmodel.paged_decode_step is None and tmodel.init_paged_cache is None
    _assert_tree(tparams, jparams)


def test_lm_prefill_and_three_decode_steps_match_jax():
    """Two prompts of 150 tokens (two mLSTM chunks) through ``lm_prefill``,
    then three ``lm_decode_step``s, the whole state tree leaf by leaf;
    and the zero cache of ``lm_init_cache``."""
    jmodel, jparams, tmodel, tparams = pair()
    _assert_tree(tmodel.init_cache(2, 64, device="cpu"),
                 jmodel.init_cache(2, 64))
    rng = np.random.RandomState(5)
    toks = rng.randint(1, 511, size=(2, 150)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, None,
                                                 64))(jparams,
                                                      jnp.asarray(toks))
    tl, tc = tmodel.prefill(tparams, _t(toks), 64)
    _assert_close(tl, jl, "logits")
    _assert_tree(tc, jc)
    jdec = jax.jit(jmodel.decode_step)
    for _ in range(3):
        last = rng.randint(1, 511, size=(2, 1)).astype(np.int32)
        jl, jc = jdec(jparams, jc, jnp.asarray(last))
        tl, tc = tmodel.decode_step(tparams, tc, _t(last))
        _assert_close(tl, jl, "logits")
        _assert_tree(tc, jc)


def test_valid_len_is_refused_as_in_jax():
    jmodel, jparams, tmodel, tparams = pair()
    toks = np.ones((1, 8), np.int32)
    with pytest.raises(ValueError, match="valid_len") as jerr:
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, None, 16,
                       jnp.asarray(5, jnp.int32))
    with pytest.raises(ValueError, match="valid_len") as terr:
        tmodel.prefill(tparams, _t(toks), 16, 5)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ engine
def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


def _staggered(srv, req_cls, prompts, max_new):
    """TestContinuousBatchingExact's submission: two requests, two ticks,
    a third mid-decode, a tick, the fourth, then drain."""
    srv.submit(req_cls(0, prompts[0], max_new))
    srv.submit(req_cls(1, prompts[1], max_new))
    out = srv.step() + srv.step()
    srv.submit(req_cls(2, prompts[2], max_new))
    out += srv.step()
    srv.submit(req_cls(3, prompts[3], max_new))
    return out + srv.run_until_drained()


COUNTS = ("prefills", "prefill_chunks", "decode_steps", "completed",
          "failed", "admitted", "ticks", "decode_tokens")
# (model, batch slots): the tiny model has 2 heads, the reduced 4, so
# "tiny-2" and "reduced-4" run at batch_slots == n_heads
STAGGERED = {"tiny-2": ("tiny", 2), "tiny-3": ("tiny", 3),
             "reduced-4": ("reduced", 4)}


@pytest.mark.parametrize("name", sorted(STAGGERED))
def test_engine_matches_jax_on_the_staggered_trace(name):
    """Greedy tokens, scheduler counts and the whole ``kv_stats()`` equal
    the JAX engine's; the requests overlapped (fewer decode ticks than
    serial generation), and the states are O(1) bytes a slot."""
    model_name, slots = STAGGERED[name]
    jmodel, jparams, tmodel, tparams = pair(model_name)
    vocab = tmodel.cfg.vocab
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, vocab - 1, size=n).tolist()
               for n in (4, 7, 5, 9)]
    jsrv = JaxBatchServer(jmodel, batch_slots=slots, max_len=32,
                          params=jparams, nic_cost=None)
    tsrv = BatchServer(tmodel, batch_slots=slots, max_len=32,
                       params=tparams, device="cpu", nic_cost=None)
    assert tsrv.continuous and not tsrv.paged and tsrv.dense_buckets == ()
    jout = _staggered(jsrv, JaxRequest, prompts, 4)
    tout = _staggered(tsrv, Request, prompts, 4)
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert len(tout) == 4
    assert {k: tsrv.stats[k] for k in COUNTS} == \
        {k: jsrv.stats[k] for k in COUNTS}
    assert tsrv.stats["decode_steps"] < 4 * 4
    assert tsrv.kv_stats() == jsrv.kv_stats()
    kv = tsrv.kv_stats()
    assert kv["per_token_bytes"] == 0 and kv["per_slot_fixed_bytes"] > 0
    assert kv["paged_kv"] is False and kv["blocks_allocated"] == 0
    assert sorted(tsrv.jit_fns()) == sorted(jsrv.jit_fns())


def test_request_past_max_len_completes_as_in_jax():
    """A 20-token prompt and 6 new tokens at max_len 16: no cap for the
    continuous family (its state is O(1)); the paged plane would fail it."""
    jmodel, jparams, tmodel, tparams = pair("tiny")
    rng = np.random.RandomState(11)
    trace = [(rng.randint(1, 127, size=n).tolist(), m)
             for n, m in ((20, 6), (3, 4), (15, 5))]
    outs = []
    for srv, codec in (
            (JaxBatchServer(jmodel, batch_slots=2, max_len=16,
                            params=jparams, nic_cost=None), jwire),
            (BatchServer(tmodel, batch_slots=2, max_len=16, params=tparams,
                         device="cpu", nic_cost=None), wire)):
        for i, (p, m) in enumerate(trace):
            srv.submit_wire(encode_request(i, p, m))
        outs.append(_outs(srv.run_until_drained(), codec))
        assert srv.stats["failed"] == 0
    assert outs[1] == outs[0]
    assert [len(outs[1][i]) for i in range(3)] == [6, 4, 5]


def test_async_engine_matches_jax():
    """Every request at once through ``run_engine`` on both engines."""
    jmodel, jparams, tmodel, tparams = pair("tiny")
    rng = np.random.RandomState(4321)
    trace = [(rng.randint(1, 127, size=n).tolist(), m)
             for n, m in [(4, 4), (9, 1), (16, 3), (1, 5), (27, 4)]]

    def drive(srv):
        async def go():
            eng = asyncio.ensure_future(srv.run_engine())
            outs = await asyncio.gather(
                *[srv.submit_async(encode_request(i, p, m))
                  for i, (p, m) in enumerate(trace)])
            srv.close()
            await eng
            return outs
        return asyncio.run(go())
    jsrv = JaxAsyncBatchServer(jmodel, batch_slots=3, max_len=32,
                               params=jparams, nic_cost=None)
    tsrv = AsyncBatchServer(tmodel, batch_slots=3, max_len=32,
                            params=tparams, device="cpu", nic_cost=None)
    assert _outs(drive(tsrv), wire) == _outs(drive(jsrv), jwire)
    assert {k: tsrv.stats[k] for k in COUNTS} == \
        {k: jsrv.stats[k] for k in COUNTS}
    assert tsrv.kv_stats() == jsrv.kv_stats()


# JAX's refusals for the ssm family: each a ValueError in both packages
BAD = {
    "paged_kv": (BatchServer, JaxBatchServer, dict(paged_kv=True),
                 "no paged decode path"),
    "prefix-cache": (BatchServer, JaxBatchServer, dict(prefix_cache=True),
                     "paged"),
    "tiering": (BatchServer, JaxBatchServer, dict(kv_overcommit=2.0),
                "paged"),
    "disagg": (DisaggEngine, JaxDisaggEngine, dict(prefill_slots=1),
               "paged"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_refusals_equal_jax(name):
    jmodel, jparams, tmodel, tparams = pair("tiny")
    tcls, jcls, kw, words = BAD[name]
    with pytest.raises(ValueError, match=words) as jerr:
        jcls(jmodel, batch_slots=2, max_len=16, params=jparams,
             nic_cost=None, **kw)
    with pytest.raises(ValueError, match=words) as terr:
        tcls(tmodel, batch_slots=2, max_len=16, params=tparams, device="cpu",
             nic_cost=None, **kw)
    assert str(terr.value) == str(jerr.value)


def test_launcher_serves_xlstm_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--prompt-len", "9", "--max-new", "3"])
    assert len(out) == 3
    text = capsys.readouterr().out
    assert "3/3 completed" in text and "kv: dense cache" in text
