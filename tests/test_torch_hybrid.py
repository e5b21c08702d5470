"""The port's hybrid slice (zamba2: Mamba2 + a shared attention block) on
the dense-cache plane against the JAX reference: the plain version of the
``ssd_scan`` kernel, ``mamba_apply`` and ``mamba_decode_step``, the hybrid
``lm_prefill`` and ``lm_decode_step`` with their cache trees, the
dense-plane ``BatchServer`` on equal-length admission waves, bf16 steps,
the weight bridge, and the launcher.

Inputs come from fixed numpy seeds and go to both frameworks as numpy
arrays.  Tolerances: the plain scan within 1e-3 of the Pallas kernel
(interpret mode) and of the sequential oracle, as the JAX suite's
``test_ssd_scan_sweep``; one Mamba2 layer and every decode step within
1e-4 at f32, as the other model tests (matmuls sum in torch's order, not
XLA's); the whole hybrid prompt forward within the scan's 1e-3, because
the chunked scan sums in another order than JAX's einsums and each
Mamba2 layer of the residual stream carries the difference into the
next, so it grows with depth; bf16 layers and steps normwise within
2e-2.  The conv state is bf16 in
both frameworks even at f32, so an f32 value a few ulps apart in the two can round to
neighbouring bf16 values: conv leaves are held to one bf16 ulp (at most
2^-7 relative) on top of the f32 tolerance, and each decode step starts from
the JAX cache, so a flip in
one step's conv tail does not carry into the next step's comparison.  The
engines' greedy wire outputs are identical.  The CUDA kernel is held
against the plain version on the card (skipped without one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import rpc as jwire
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.models.model import build_model as jax_build_model
from repro.runtime.server import BatchServer as JaxBatchServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.runtime.server import BatchServer, encode_request

HYBRID = "zamba2-7b"
F32 = dict(param_dtype="float32", cache_dtype="float32")
BF16 = dict(param_dtype="bfloat16", cache_dtype="bfloat16")
# reduced zamba2 with a tail: hybrid_layout (2, 2, 1)
TAIL = dict(n_layers=5)
SCAN_TOL = dict(atol=1e-3, rtol=1e-3)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2
MAX_LEN = 32
jax_prefill = jax.jit(lambda p, cfg, t, n: jtr.lm_prefill(
    p, cfg, {"tokens": t}, max_len=n), static_argnums=(1, 3))
jax_decode = jax.jit(jtr.lm_decode_step, static_argnums=(1,))


def _configs(dtypes=F32, **over):
    over = dict(dtypes, **over)
    return (jax_reduced(jax_get_config(HYBRID)).replace(**over),
            reduced(get_config(HYBRID)).replace(**over))


def _bridge(jparams, dtype=torch.float32):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", dtype)


def _t(a):
    """numpy/JAX array -> CPU tensor of the same dtype (bf16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_bf16_ulp(got, exp, tol=None):
    """Equal up to one bf16 ulp (at most 2^-7 of the value), on top of
    ``tol`` (atol, rtol) for the f32 values the frameworks rounded."""
    got, exp = _f32(got), _f32(exp)
    assert got.shape == exp.shape
    atol, rtol = (tol["atol"], tol["rtol"]) if tol else (0.0, 0.0)
    bound = atol + (rtol + 2.0 ** -7) * np.abs(exp)
    assert (np.abs(got - exp) <= bound).all(), \
        float((np.abs(got - exp) - bound).max())


def _assert_bf16_close(got, exp):
    """Normwise at 2e-2: the largest difference within 2e-2 of the
    largest magnitude (bf16 rounds at different places in the two
    frameworks, so small entries can differ by much of themselves)."""
    got, exp = _f32(got), _f32(exp)
    assert got.shape == exp.shape
    err = float(np.abs(got - exp).max())
    assert err <= BF16_TOL * float(np.abs(exp).max()), \
        (err, float(np.abs(exp).max()))


def _assert_cache(got, exp, tol=STEP_TOL):
    """The whole cache tree: same leaves, dtypes and shapes; k, v and ssm
    within ``tol``, conv (bf16 in both) within ``tol`` and one bf16 ulp,
    cur equal."""
    assert sorted(got) == sorted(exp)
    for name in exp:
        e = np.asarray(exp[name])
        g = got[name]
        assert tuple(g.shape) == e.shape, name
        assert str(g.dtype).split(".")[-1] == e.dtype.name, name
        if name == "conv":
            _assert_bf16_ulp(g, e, tol)
        elif name == "cur":
            assert int(g) == int(e)
        else:
            np.testing.assert_allclose(_f32(g), _f32(e), err_msg=name, **tol)


def _scan_inputs(rng, B, L, h, hd, S):
    x = (rng.randn(B, L, h, hd) * 0.5).astype(np.float32)
    Bm = (rng.randn(B, L, S) * 0.3).astype(np.float32)
    Cm = (rng.randn(B, L, S) * 0.3).astype(np.float32)
    dt = (np.abs(rng.randn(B, L, h)) * 0.1).astype(np.float32)
    A = -(np.abs(rng.randn(h)) + 0.2).astype(np.float32)
    return x, Bm, Cm, dt, A


# ------------------------------------------------------------ ssd_scan
@pytest.mark.parametrize("B,L,h,hd,S,chunk", [
    (1, 128, 2, 32, 16, 64), (2, 256, 3, 32, 16, 64),
    (1, 256, 1, 64, 32, 128), (2, 77, 2, 32, 16, 64)],
    ids=["one-chunk-pair", "four-chunks", "chunk128", "ragged"])
def test_plain_ssd_scan_matches_pallas_and_oracle(B, L, h, hd, S, chunk):
    """The shapes of tests/test_kernels.py's sweep plus a ragged L (the
    Pallas kernel needs L % chunk == 0, so the ragged case is held to the
    sequential oracle only)."""
    rng = np.random.RandomState(L + 7 * h)
    arrs = _scan_inputs(rng, B, L, h, hd, S)
    before = ops.LAUNCHES["ssd_scan"]
    y, st = ops.ssd_scan(*map(_t, arrs), chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == before, "the CPU path launched"
    assert y.shape == (B, L, h, hd) and y.dtype == torch.float32
    assert st.shape == (B, h, hd, S) and st.dtype == torch.float32
    oracle = np.asarray(jref.ssd_scan(*map(jnp.asarray, arrs)))
    np.testing.assert_allclose(y.numpy(), oracle, **SCAN_TOL)
    if L % chunk == 0:
        pallas = jops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **SCAN_TOL)


# chip_smoke.py phase 3's odd shapes: chunk 1, hd and S not multiples of
# 8 (hd 130: three 64-column slabs of the card kernel, the last 2 wide),
# and a decay so strong that exp(acs) underflows to 0
ODD_SCANS = [(2, 37, 3, 24, 16, 1, "normal"),
             (2, 150, 5, 20, 13, 128, "normal"),
             (1, 200, 2, 130, 70, 48, "normal"),
             (2, 256, 4, 16, 16, 128, "strong")]
ODD_IDS = ["chunk1", "hd20-S13", "hd130-S70-chunk48", "strong-decay"]


def _odd_scan_inputs(B, L, h, hd, S, decay):
    rng = np.random.RandomState(L + hd + S)
    x, Bm, Cm, dt, A = _scan_inputs(rng, B, L, h, hd, S)
    if decay == "strong":     # dt A under -30 a step: exp(acs) -> 0
        dt = (np.abs(rng.randn(B, L, h)) + 0.5).astype(np.float32)
        A = np.full((h,), -60.0, np.float32)
    return x, Bm, Cm, dt, A


@pytest.mark.parametrize("B,L,h,hd,S,chunk,decay", ODD_SCANS, ids=ODD_IDS)
def test_plain_ssd_scan_odd_shapes_match_oracle(B, L, h, hd, S, chunk,
                                                decay):
    """The plain version at the odd shapes the card kernel is checked at
    (its padding paths) against the sequential oracle; the strong decay
    leaves y close to the diagonal term and the state close to the last
    step's."""
    arrs = _odd_scan_inputs(B, L, h, hd, S, decay)
    y, st = ops.ssd_scan(*map(_t, arrs), chunk=chunk)
    oracle = np.asarray(jref.ssd_scan(*map(jnp.asarray, arrs)))
    np.testing.assert_allclose(y.numpy(), oracle, **SCAN_TOL)
    assert torch.isfinite(st).all()
    if decay == "strong":
        x, Bm, Cm, dt, A = arrs
        last = dt[:, -1, :, None, None] * x[:, -1, :, :, None] \
            * Bm[:, -1, None, None, :]
        np.testing.assert_allclose(st.numpy(), last, **SCAN_TOL)


def _jax_scan_inputs(p, x, cfg):
    """mamba_apply's own scan inputs (projections, causal conv, A), from
    JAX's functions and its lines."""
    B, L, _ = x.shape
    z, xin_raw, Bm, Cm, dt = jssm._proj(p, x, cfg)
    w = cfg.conv_width
    xc = jnp.concatenate([jnp.zeros((B, w - 1, cfg.d_inner), x.dtype),
                          xin_raw], axis=1)
    kern = p["conv"].astype(jnp.float32)
    xin = sum(xc[:, i:i + L].astype(jnp.float32) * kern[i] for i in range(w))
    xin = jax.nn.silu(xin).astype(x.dtype)
    A = -jnp.exp(p["A_log"].astype(jnp.float32))
    xh = xin.reshape(B, L, cfg.n_ssm_heads, cfg.ssm_head_dim)
    return xh, Bm, Cm, dt, A


def _mamba_params(seed, jcfg):
    """One Mamba2 layer's params (random A_log, D_skip, dt_bias and gnorm,
    so every term is exercised) as numpy."""
    rng = np.random.RandomState(seed)
    D, di, S, h = jcfg.d_model, jcfg.d_inner, jcfg.ssm_state, \
        jcfg.n_ssm_heads
    shapes = {"wz": (D, di), "wx": (D, di), "wB": (D, S), "wC": (D, S),
              "wdt": (D, h), "conv": (jcfg.conv_width, di), "A_log": (h,),
              "D_skip": (h,), "dt_bias": (h,), "gnorm": (di,),
              "wo": (di, D)}
    return {k: (rng.randn(*s) / np.sqrt(s[0] if len(s) > 1 else 4))
            .astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("L", [128, 150])
def test_ssd_scan_final_state_matches_mamba_apply(L):
    """The scan's final state is what mamba_apply(return_state=True)
    returns as the decode state ("ssm"), including after a ragged chunk."""
    jcfg, _ = _configs()
    pn = _mamba_params(1, jcfg)
    jp = {k: jnp.asarray(v) for k, v in pn.items()}
    x = np.random.RandomState(L).randn(2, L, jcfg.d_model).astype(np.float32)
    _, jst = jssm.mamba_apply(jp, jnp.asarray(x), jcfg, return_state=True)
    xh, Bm, Cm, dt, A = _jax_scan_inputs(jp, jnp.asarray(x), jcfg)
    _, st = ops.ssd_scan(*(_t(a) for a in (xh, Bm, Cm, dt, A)),
                         chunk=tssm.CHUNK)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst["ssm"]),
                               **SCAN_TOL)


# ------------------------------------------------------------ ssm layer
@pytest.mark.parametrize("L", [2, 77, 128, 150])
def test_mamba_apply_matches_jax(L):
    """Output, ssm state and the bf16 conv tail (the last w - 1 raw
    inputs; zero-padded when L < w - 1)."""
    jcfg, tcfg = _configs()
    pn = _mamba_params(2, jcfg)
    x = np.random.RandomState(L + 1).randn(2, L, jcfg.d_model) \
        .astype(np.float32)
    jout, jst = jssm.mamba_apply({k: jnp.asarray(v) for k, v in pn.items()},
                                 jnp.asarray(x), jcfg, return_state=True)
    tp = {k: torch.from_numpy(v) for k, v in pn.items()}
    tout, tst = tssm.mamba_apply(tp, torch.from_numpy(x), tcfg,
                                 return_state=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **STEP_TOL)
    np.testing.assert_allclose(tst["ssm"].numpy(), np.asarray(jst["ssm"]),
                               **STEP_TOL)
    assert tst["conv"].dtype == torch.bfloat16
    _assert_bf16_ulp(tst["conv"], jst["conv"])
    assert torch.equal(tssm.mamba_apply(tp, torch.from_numpy(x), tcfg),
                       tout)


def test_mamba_decode_step_matches_jax():
    jcfg, tcfg = _configs()
    pn = _mamba_params(3, jcfg)
    rng = np.random.RandomState(5)
    B = 3
    x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
    ssm0 = rng.randn(B, jcfg.n_ssm_heads, jcfg.ssm_head_dim,
                     jcfg.ssm_state).astype(np.float32)
    conv0 = jnp.asarray(rng.randn(B, jcfg.conv_width - 1, jcfg.d_inner),
                        jnp.bfloat16)
    jout, jst = jssm.mamba_decode_step(
        {k: jnp.asarray(v) for k, v in pn.items()}, jnp.asarray(x),
        {"ssm": jnp.asarray(ssm0), "conv": conv0}, jcfg)
    tout, tst = tssm.mamba_decode_step(
        {k: torch.from_numpy(v) for k, v in pn.items()}, torch.from_numpy(x),
        {"ssm": torch.from_numpy(ssm0), "conv": _t(conv0)}, tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **STEP_TOL)
    np.testing.assert_allclose(tst["ssm"].numpy(), np.asarray(jst["ssm"]),
                               **STEP_TOL)
    assert tst["conv"].dtype == torch.bfloat16
    _assert_bf16_ulp(tst["conv"], jst["conv"])
    # the ring shifts: the first w - 2 rows are the old state's last ones
    assert torch.equal(tst["conv"][:, :-1], _t(conv0)[:, 1:])
    jinit, tinit = jssm.mamba_init_state(jcfg, B), \
        tssm.mamba_init_state(tcfg, B)
    for name in ("ssm", "conv"):
        assert tuple(tinit[name].shape) == jinit[name].shape
        assert str(tinit[name].dtype).split(".")[-1] == \
            jinit[name].dtype.name
        assert not tinit[name].any()


# ------------------------------------------------------------ model
@pytest.fixture(scope="module")
def tail_model():
    jcfg, tcfg = _configs(**TAIL)
    assert jtr.hybrid_layout(jcfg) == ttr.hybrid_layout(tcfg) == (2, 2, 1)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    return jcfg, tcfg, jparams, _bridge(jparams)


def test_schema_and_bridge_carry_the_hybrid_tree(tail_model):
    """The port's schema has JAX's leaves and shapes (mamba_groups stacked
    (n_groups, every, ...), mamba_tail, shared), and the bridge carries
    every leaf across unchanged."""
    jcfg, tcfg, jparams, tparams = tail_model
    jleaves = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_flatten_with_path(jparams)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v
    tleaves = dict(flat(tparams))
    assert sorted(tleaves) == sorted(jleaves)
    for k, v in jleaves.items():
        assert tuple(tleaves[k].shape) == v.shape, k
        np.testing.assert_array_equal(tleaves[k].numpy(), np.asarray(v))
    assert tleaves["['mamba_groups']['wx']"].shape[:2] == (2, 2)
    assert tleaves["['mamba_tail']['wx']"].shape[0] == 1
    schema = build_model(tcfg).schema
    assert sorted(schema) == sorted(jparams)
    assert tuple(schema["mamba_groups"]["conv"].shape) == \
        jparams["mamba_groups"]["conv"].shape


def test_lm_prefill_and_three_decode_steps_match_jax(tail_model):
    """lm_prefill packed to max_len (at the scan's tolerance), then three
    lm_decode_step calls, each from the JAX cache of the step before
    (bridged), all cache leaves compared; the port updates its cache in
    place."""
    jcfg, tcfg, jparams, tparams = tail_model
    rng = np.random.RandomState(11)
    toks = rng.randint(1, jcfg.vocab - 1, size=(2, 13)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), MAX_LEN)
    tl, tc = ttr.lm_prefill(tparams, tcfg, torch.from_numpy(toks), MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SCAN_TOL)
    _assert_cache(tc, jc, SCAN_TOL)
    assert tc["k"].shape == (2, 2, MAX_LEN, tcfg.n_kv_heads, tcfg.head_dim)
    assert not tc["k"][:, :, 13:].any(), "positions past S are zero"
    for _ in range(3):
        step = rng.randint(1, jcfg.vocab - 1, size=(2, 1)).astype(np.int32)
        start = {k: _t(v) for k, v in jc.items()}
        jl, jc = jax_decode(jparams, jcfg, jc, jnp.asarray(step))
        tl, tc = ttr.lm_decode_step(tparams, tcfg, start,
                                    torch.from_numpy(step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
        _assert_cache(tc, jc)
        assert tc["ssm"] is start["ssm"], "the ssm state updates in place"


def test_init_cache_and_first_decode_step_match_jax(tail_model):
    """lm_init_cache's tree equals JAX's (an f32 conv leaf at cache dtype
    f32), and a decode step from it hands back a bf16 conv leaf, as JAX's
    does."""
    jcfg, tcfg, jparams, tparams = tail_model
    jc = jtr.lm_init_cache(jcfg, 3, MAX_LEN)
    tc = ttr.lm_init_cache(tcfg, 3, MAX_LEN)
    _assert_cache(tc, jc)
    assert tc["conv"].dtype == torch.float32
    step = np.array([[5], [9], [17]], np.int32)
    jl, jc = jax_decode(jparams, jcfg, jc, jnp.asarray(step))
    tl, tc = ttr.lm_decode_step(tparams, tcfg, tc, torch.from_numpy(step))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    _assert_cache(tc, jc)
    assert tc["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("L", [9, 150])
def test_bf16_mamba_layer_normwise(L):
    """One bf16 Mamba2 layer (params and input rounded to bf16 once, then
    the same in both frameworks): output and decode state at 2e-2
    normwise."""
    jcfg, tcfg = _configs(BF16)
    pn = _mamba_params(4, jcfg)
    x = np.random.RandomState(L + 2).randn(2, L, jcfg.d_model) \
        .astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in pn.items()}
    jout, jst = jssm.mamba_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                 return_state=True)
    tout, tst = tssm.mamba_apply({k: _t(v) for k, v in jp.items()},
                                 _t(jnp.asarray(x, jnp.bfloat16)), tcfg,
                                 return_state=True)
    assert tout.dtype == torch.bfloat16
    _assert_bf16_close(tout, jout)
    _assert_bf16_close(tst["ssm"], jst["ssm"])
    _assert_bf16_close(tst["conv"], jst["conv"])


@pytest.mark.parametrize("S", [9, 13, 29])
def test_bf16_shared_attention_block_matches_jax(S):
    """The bf16 5-layer hybrid's shared attention block against JAX's
    jitted one on the same bf16 input.  Its attention (q/k/v, the prompt
    attention, wo) on the same bf16 input is held to what the bf16
    softmax weights allow: no element off by more than one bf16 ulp of
    the largest output (2^-8 of it: f32 sum order may flip one rounding),
    and fewer than 1% of the elements off at all.  The prompt attention
    rounds its weights to bf16 before P.V as JAX's gqa_attention does;
    with f32 weights about half of the elements differ by one ulp.  The
    whole block (ln1, attention, residual) and its k/v are held
    normwise at 2e-2."""
    jcfg, tcfg = _configs(BF16, **TAIL)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(S))
    tparams = _bridge(jparams, torch.bfloat16)
    x = jnp.asarray(np.random.RandomState(S + 1).randn(2, S, jcfg.d_model),
                    jnp.bfloat16)
    jattn, _ = jax.jit(lambda p, h: jlayers.attn_apply(
        p, h, jcfg, positions=jnp.arange(S)))(jparams["shared"]["attn"], x)
    tattn, _ = tlayers.attn_apply(tparams["shared"]["attn"], _t(x), tcfg)
    assert tattn.dtype == torch.bfloat16
    got, exp = _f32(tattn), _f32(jattn)
    off = np.abs(got - exp)
    assert off.max() <= 2.0 ** -8 * np.abs(exp).max(), \
        (float(off.max()), float(np.abs(exp).max()))
    assert np.count_nonzero(off) < 0.01 * off.size, \
        (np.count_nonzero(off), off.size)
    jout, (jk, jv) = jax.jit(
        lambda p, x: jtr._attn_block(p, x, jcfg, None, jnp.arange(S), None,
                                     0, True))(jparams["shared"], x)
    tout, (tk, tv) = ttr._attn_block(tparams["shared"], _t(x), tcfg)
    assert tout.dtype == torch.bfloat16
    _assert_bf16_close(tout, jout)
    _assert_bf16_close(tk, jk)
    _assert_bf16_close(tv, jv)


@pytest.mark.parametrize("layout", ["tail-only", "one-group"])
def test_bf16_prefill_and_decode_step_normwise(layout):
    """One bf16 prefill and one decode step (from the JAX cache) at 2e-2
    normwise.  Tail-only (n_layers 1: a single Mamba2 layer, no attention)
    holds the prefill and the step; one group (the shared attention block
    and one Mamba2 layer) holds the step.  Its bf16 prefill is not held
    here: the jitted JAX forward fuses bf16 elementwise chains (the FFN,
    the Mamba2 layer) and skips roundings that JAX's own op-by-op run and
    the port make, and the random layers grow that past 2e-2 at the
    logits.  The shared attention block is held in
    test_bf16_shared_attention_block_matches_jax, a bf16 Mamba2 layer
    given the same input in test_bf16_mamba_layer_normwise."""
    over = dict(n_layers=1, hybrid_attn_every=2 if layout == "tail-only"
                else 1)
    jcfg, tcfg = _configs(BF16, **over)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(4))
    tparams = _bridge(jparams, torch.bfloat16)
    rng = np.random.RandomState(12)
    toks = rng.randint(1, jcfg.vocab - 1, size=(2, 9)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), MAX_LEN)
    tl, tc = ttr.lm_prefill(tparams, tcfg, torch.from_numpy(toks), MAX_LEN)
    if layout == "tail-only":
        _assert_bf16_close(tl, jl)
        for name in ("ssm", "conv"):
            _assert_bf16_close(tc[name], jc[name])
    step = np.array([[3], [7]], np.int32)
    start = {k: _t(v) for k, v in jc.items()}
    jl, jc = jax_decode(jparams, jcfg, jc, jnp.asarray(step))
    tl, tc = ttr.lm_decode_step(tparams, tcfg, start, torch.from_numpy(step))
    _assert_bf16_close(tl, jl)
    for name in ("k", "v", "ssm", "conv"):
        if tc[name].numel():
            _assert_bf16_close(tc[name], jc[name])


def test_model_api_on_the_dense_plane(tail_model):
    """Hybrid has no paged callables (as JAX's build_model); the dense
    family has both planes, its dense cache an (L, B, max_len, K, hd) KV
    stack (the hybrid's dense-plane tests stay as they were)."""
    _, tcfg, _, _ = tail_model
    model = build_model(tcfg)
    assert model.paged_decode_step is None and model.init_paged_cache is None
    assert model.paged_prefill_chunk is None and \
        model.paged_prefill_write is None
    cache = model.init_cache(2, MAX_LEN, device="cpu")
    assert cache["k"].shape[:3] == (2, 2, MAX_LEN)
    dense = reduced(get_config("mistral-nemo-12b"))
    dmodel = build_model(dense)
    assert dmodel.init_paged_cache is not None and \
        dmodel.decode_step is not None
    dcache = ttr.lm_init_cache(dense, 2, MAX_LEN)
    assert sorted(dcache) == ["cur", "k", "v"]
    assert dcache["k"].shape == (dense.n_layers, 2, MAX_LEN,
                                 dense.n_kv_heads, dense.head_dim)
    with pytest.raises(ValueError, match="no paged KV path"):
        ttr.lm_init_paged_cache(tcfg, 2, MAX_LEN)


# ------------------------------------------------------------ engine
def _wave_trace(vocab):
    """Equal prompt lengths back to back, so groups and waves form."""
    rng = np.random.RandomState(77)
    return [(rng.randint(1, vocab - 1, size=n).tolist(), m)
            for n, m in [(6, 3)] * 4 + [(11, 2)] * 3 + [(6, 4), (20, 3)]]


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


@pytest.mark.parametrize("prefill_batch", [1, 2])
def test_engine_matches_jax_on_two_waves(tail_model, prefill_batch):
    """Equal greedy tokens, equal scheduler counters and equal pool
    accounting (the reference's per-token footprint of the ssm and conv
    leaves included) against the JAX engine on the dense plane."""
    jcfg, tcfg, jparams, tparams = tail_model
    trace = _wave_trace(jcfg.vocab)
    bufs = [encode_request(i, p, m) for i, (p, m) in enumerate(trace)]
    jsrv = JaxBatchServer(jax_build_model(jcfg), batch_slots=4,
                          max_len=MAX_LEN, params=jparams, nic_cost=None,
                          prefill_batch=prefill_batch)
    tsrv = BatchServer(build_model(tcfg), batch_slots=4, max_len=MAX_LEN,
                       params=tparams, device="cpu", nic_cost=None,
                       prefill_batch=prefill_batch)
    assert not tsrv.paged and tsrv.prefill_chunk == 0
    for buf in bufs:
        jsrv.submit_wire(buf)
        tsrv.submit_wire(buf)
    jout = jsrv.run_until_drained()
    tout = tsrv.run_until_drained()
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert sorted(tout) == sorted(jout)          # byte-identical responses
    assert len(tout) == len(trace) and tsrv.stats["failed"] == 0
    for key in ("prefills", "decode_steps", "completed", "admitted",
                "ticks", "decode_tokens", "prefill_chunks"):
        assert tsrv.stats[key] == jsrv.stats[key], key
    tkv, jkv = tsrv.kv_stats(), jsrv.kv_stats()
    for key in ("per_token_bytes", "per_slot_fixed_bytes",
                "blocks_allocated", "blocks_freed", "kv_tier"):
        assert tkv[key] == jkv[key], key
    assert tkv["paged_kv"] is False


def test_engine_refuses_paged_options_for_hybrid(tail_model):
    _, tcfg, _, tparams = tail_model
    model = build_model(tcfg)
    with pytest.raises(ValueError, match="no paged decode path"):
        BatchServer(model, batch_slots=2, max_len=MAX_LEN, params=tparams,
                    device="cpu", nic_cost=None, paged_kv=True)
    with pytest.raises(ValueError, match="requires the paged KV plane"):
        BatchServer(model, batch_slots=2, max_len=MAX_LEN, params=tparams,
                    device="cpu", nic_cost=None, prefill_chunk=8)


def test_launcher_serves_zamba2_on_cpu(capsys):
    out = serve.main(["--arch", HYBRID, "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--prompt-len", "9", "--max-new", "3",
                      "--no-paged-kv"])
    assert len(out) == 3
    text = capsys.readouterr().out
    assert "3/3 completed" in text and "dense cache" in text


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_mma_geometry_fits_every_accepted_shape(dtype):
    """The tensor-core kernel's two launches fit one CTA's shared memory
    at every chunk and every hd and S the wrapper accepts (those whose
    CUDA-core CTA fits), and at least one scan CTA fits an SM."""
    for chunk in range(1, ops.MAX_SSD_CHUNK + 1):
        for hd in (1, 7, 8, 20, 63, 64, 65, 130, 4000):
            for S in (1, 13, 64, 70, 1000, 14000):
                if ops._ssd_smem_bytes(chunk, hd, S) > ops.SMEM_LIMIT:
                    continue
                geo = ops.ssd_scan_mma_geometry(2, 300, 3, hd, S, chunk,
                                                dtype)
                assert geo["smem"] <= ops.SMEM_LIMIT
                assert geo["prep_smem"] <= ops.SMEM_LIMIT
                assert geo["ctas_per_sm"] >= 1
                assert geo["grid"] == (3 * -(-hd // 64), 2)


@pytest.mark.parametrize("L,scratch", [(189, 204800), (64, 102400)],
                         ids=["max-group-call", "smallest-group-call"])
def test_ssd_mma_geometry_at_zamba2(L, scratch):
    """zamba2's group calls, x (4, L, 112, 64) bf16, S 64, chunk 128: one
    scan CTA per (head, row), 4 of them an SM, so the 448 fit the 132 SMs
    in one wave; the C.B^T launch takes a CTA per (16-row tile, chunk,
    row), and its fragments (G, C and B^T) are 0.8 MB at L 189.  f32 x
    keeps 2 CTAs an SM."""
    geo = ops.ssd_scan_mma_geometry(4, L, 112, 64, 64, 128, torch.bfloat16)
    assert geo["grid"] == (112, 4) and geo["threads"] == 128
    assert geo["smem"] == 2 * 128 * 72 * 2 + 4 * (64 * 68 + 5 * 128) \
        == 56832
    assert geo["ctas_per_sm"] == 4 and geo["waves"] == 1
    assert geo["prep_grid"] == (8 * -(-L // 128), 4)
    assert geo["prep_smem"] == 4 * (16 * 68 * 9 + 16 * 132) == 47616
    assert geo["scratch_floats"] == scratch
    f32 = ops.ssd_scan_mma_geometry(4, L, 112, 64, 64, 128, torch.float32)
    assert f32["smem"] == 2 * 128 * 68 * 4 + 4 * (64 * 68 + 5 * 128) \
        == 89600
    assert f32["ctas_per_sm"] == 2


@pytest.mark.parametrize("chunk", [1, 128])
def test_ssd_mma_geometry_chunk_bounds(chunk):
    """chunk 1: one 16-row tile a chunk (rows 1-15 zero-filled), one C.B^T
    CTA per step; chunk 128: eight.  The fragments of a (row, chunk): G's
    rt (rt + 1) tiles on and below the diagonal, C's rt x 8 and B^T's
    4 x 2 rt per 64 columns of S."""
    rt = -(-chunk // 16)
    geo = ops.ssd_scan_mma_geometry(3, 300, 5, 96, 100, chunk,
                                    torch.float32)
    n_chunks = -(-300 // chunk)
    assert geo["prep_grid"] == (rt * n_chunks, 3)
    assert geo["grid"] == (5 * 2, 3)
    assert geo["smem"] == 2 * 16 * rt * 68 * 4 + 4 * (64 * 68 + 5 * 16 * rt)
    frags = rt * (rt + 1) + rt * 8 * 2 + 4 * 2 * 2 * rt
    assert geo["scratch_floats"] == 3 * n_chunks * frags * 128


def _scan_args(shape_over=None, dtype_over=None, chunk=128):
    """CPU tensors of a valid ssd_scan call (B 1, L 8, h 2, hd 16, S 4),
    with one argument's shape or dtype replaced."""
    shapes = dict(x=(1, 8, 2, 16), Bm=(1, 8, 4), Cm=(1, 8, 4), dt=(1, 8, 2),
                  A=(2,))
    shapes.update(shape_over or {})
    args = {k: torch.zeros(v) for k, v in shapes.items()}
    for k, dt in (dtype_over or {}).items():
        args[k] = args[k].to(dt)
    return [args[k] for k in ("x", "Bm", "Cm", "dt", "A")], chunk


@pytest.mark.parametrize("over,err,match", [
    (dict(dtype_over=dict(Bm=torch.float64)), TypeError,
     "Bm must be float32"),
    (dict(dtype_over=dict(x=torch.float16)), TypeError,
     "x dtype torch.float16 unsupported"),
    (dict(shape_over=dict(dt=(1, 8, 3))), ValueError, "do not match x"),
    (dict(shape_over=dict(x=(8, 2, 16))), ValueError,
     r"is not \(B, L, h, hd\)"),
    (dict(chunk=0), ValueError, r"chunk 0 not in \[1, 128\]"),
    (dict(chunk=129), ValueError, r"chunk 129 not in \[1, 128\]"),
    (dict(shape_over=dict(Bm=(1, 8, 0), Cm=(1, 8, 0))), ValueError,
     "bytes of shared memory"),
    (dict(shape_over=dict(x=(1, 8, 2, 300), Bm=(1, 8, 200), Cm=(1, 8, 200))),
     ValueError, r"need 666784 bytes of shared memory \(limit 232448\)"),
], ids=["Bm-f64", "x-f16", "dt-shape", "x-3d", "chunk0", "chunk129", "S0",
        "smem"])
def test_ssd_scan_card_checks_refuse_as_before(over, err, match):
    """What the wrapper refuses on the card, with the same errors as
    before the tensor-core kernel: the checks run on CPU tensors here."""
    args, chunk = _scan_args(**over)
    with pytest.raises(err, match=match):
        ops._check_ssd(*args, chunk)


def test_ssd_scan_card_checks_refuse_non_contiguous():
    args, chunk = _scan_args()
    args[1] = torch.zeros(1, 4, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="Bm must be contiguous"):
        ops._check_ssd(*args, chunk)
    args, chunk = _scan_args()
    args[0] = torch.zeros(1, 8, 16, 2).transpose(2, 3)
    with pytest.raises(ValueError, match="x must be contiguous"):
        ops._check_ssd(*args, chunk)
    assert ops._check_ssd(*_scan_args()[0], 128) == (1, 8, 2, 16, 4)


# ------------------------------------------------------------ devices
def test_wrapper_refuses_devices_without_a_kernel():
    meta = dict(device="meta")
    args = (torch.empty(1, 8, 2, 16, **meta), torch.empty(1, 8, 4, **meta),
            torch.empty(1, 8, 4, **meta), torch.empty(1, 8, 2, **meta),
            torch.empty(2, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan(*args)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on_card_scan(args, chunk, dtype):
    """The wrapper on the card (one call, on the tensor-core kernel)
    against the plain version on the same inputs: within 1e-3 abs + rel
    with f32 x, 2e-2 normwise with bf16 x."""
    args = [args[0].to(dtype)] + list(args[1:])
    before = dict(ops.LAUNCHES)
    y, st = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k in ("ssd_scan", "ssd_scan_mma")) for k in before}
    ey, est = ref.ssd_scan(*args, chunk=chunk)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ey, **SCAN_TOL)
        torch.testing.assert_close(st, est, **SCAN_TOL)
    else:
        _assert_bf16_close(y.cpu(), ey.cpu())
        _assert_bf16_close(st.cpu(), est.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [256, 209])
def test_ssd_kernel_matches_plain_on_card(cuda, L, dtype):
    rng = np.random.RandomState(L)
    arrs = _scan_inputs(rng, 2, L, 112, 64, 64)
    _on_card_scan([torch.from_numpy(a).to(cuda) for a in arrs], 128, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,h,hd,S,chunk,decay", ODD_SCANS, ids=ODD_IDS)
def test_ssd_kernel_odd_shapes_on_card(cuda, B, L, h, hd, S, chunk, decay,
                                       dtype):
    arrs = _odd_scan_inputs(B, L, h, hd, S, decay)
    _on_card_scan([torch.from_numpy(a).to(cuda) for a in arrs], chunk,
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 189, 112, 64, 64, 128),
                                   (4, 64, 112, 64, 64, 128),
                                   (2, 37, 3, 24, 16, 1),
                                   (1, 200, 2, 130, 70, 48)],
                         ids=["zamba2-max", "zamba2-smallest", "chunk1",
                              "hd130"])
def test_ssd_mma_geometry_matches_on_card(cuda, shape, dtype):
    """ssd_scan_mma_geometry's sizes and grids are the library's, the card
    holds at least the CTAs an SM it computes, and the scan kernel keeps
    to the registers its launch bounds allow."""
    geo = ops.ssd_scan_mma_geometry(*shape, dtype)
    card = ops.ssd_scan_mma_card_geometry(*shape, dtype)
    assert card["scratch_floats"] == geo["scratch_floats"]
    assert (card["smem"], card["prep_smem"]) == (geo["smem"],
                                                 geo["prep_smem"])
    assert (card["grid_x"], card["grid_y"]) == geo["grid"]
    assert card["prep_grid_x"] == geo["prep_grid"][0]
    assert card["ctas_per_sm"] >= geo["ctas_per_sm"]
    assert card["registers"] <= ops.SSD_MAX_REGS


def test_ssd_scan_refuses_on_card(cuda):
    """The card call refuses what it refused, with the same errors."""
    args, chunk = _scan_args(chunk=129)
    with pytest.raises(ValueError, match=r"chunk 129 not in \[1, 128\]"):
        ops.ssd_scan(*[a.to(cuda) for a in args], chunk=chunk)
    args, _ = _scan_args(dtype_over=dict(dt=torch.float64))
    with pytest.raises(TypeError, match="dt must be float32"):
        ops.ssd_scan(*[a.to(cuda) for a in args])
