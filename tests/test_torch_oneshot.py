"""The port's one-shot paged prefill slice against the JAX reference: the
plain versions of the ``flash_attention`` and ``rmsnorm`` kernels, the
exact-length prompt forward (``lm_prefill``) and its page write, the
one-shot ``BatchServer`` (dense, dropless and capacity-routed MoE,
``prefill_batch`` 1 and 4), the launcher, the decode timer's window, and
bf16 steps.

Inputs come from fixed numpy seeds and go to both frameworks as numpy
arrays.  Tolerances: the plain kernels within 1e-5 at f32 (against the
Pallas kernels in interpret mode); the model forward within 1e-4 at f32,
as the other model tests (matmuls sum in torch's order, not XLA's); the
engines' greedy wire outputs identical; bf16 steps within the north
star's 2e-2.  The hand-written CUDA kernels are held against the plain
versions on the card (skipped without one).
"""
import time

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
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.model import build_model as jax_build_model
from repro.runtime.scheduler import Request as JaxRequest
from repro.runtime.server import BatchServer as JaxBatchServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import BatchServer, encode_request

DENSE, MOE = "mistral-nemo-12b", "granite-moe-3b-a800m"
F32 = dict(param_dtype="float32", cache_dtype="float32")
BF16 = dict(param_dtype="bfloat16", cache_dtype="bfloat16")
# the _tiny overrides of tests/test_differential.py
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128)
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2
MAX_LEN = 32
jax_prefill = jax.jit(lambda p, cfg, t: jtr.lm_prefill(p, cfg, {"tokens": t}),
                      static_argnums=(1,))
jax_write = jax.jit(jtr.lm_paged_prefill_write, static_argnums=(0, 5, 6))
jax_chunk = jax.jit(jtr.lm_paged_prefill_chunk, static_argnums=(1,))
jax_decode = jax.jit(jtr.lm_paged_decode_step, static_argnums=(1,))


def _configs(arch=DENSE, routing=None, dtypes=F32, **over):
    over = dict(TINY, **dtypes, **over)
    if routing is not None:
        over["moe_routing"] = routing
    return (jax_reduced(jax_get_config(arch)).replace(**over),
            reduced(get_config(arch)).replace(**over))


def _bridge(jparams, dtype=torch.float32):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _assert_bf16_close(got, exp):
    """Normwise at the north star's bf16 tolerance: the largest difference
    within 2e-2 of the largest magnitude.  Element by element a bf16 value
    of magnitude m carries 2^-8 m of rounding, and the frameworks round at
    different places through a step (XLA fuses bf16 elementwise chains
    under jit and skips roundings that eager PyTorch makes), so small
    entries can differ by a large fraction of themselves."""
    got, exp = _f32(got), _f32(exp)
    assert got.shape == exp.shape
    err = float(np.abs(got - exp).max())
    assert err <= BF16_TOL * float(np.abs(exp).max()), \
        (err, float(np.abs(exp).max()))


# ------------------------------------------------------------ flash
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("H,K", [(4, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("S", [64, 128, 256])
def test_plain_flash_attention_matches_pallas(S, H, K, window):
    """The plain version reads the K kv heads directly; JAX's wrapper
    repeats them to H and runs the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(S + 10 * H + K + window)
    B, hd = 2, 32
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, K, hd).astype(np.float32)
    v = rng.randn(B, S, K, hd).astype(np.float32)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window)
    assert ops.LAUNCHES["flash_attention"] == before, "the CPU path launched"
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window,
                                  use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **KERNEL_TOL)
    # the oracle on kv heads expanded by hand, in its (B, H, S, hd) layout
    kx = np.repeat(k, H // K, axis=2).transpose(0, 2, 1, 3)
    vx = np.repeat(v, H // K, axis=2).transpose(0, 2, 1, 3)
    oracle = jref.flash_attention(jnp.asarray(q.transpose(0, 2, 1, 3)),
                                  jnp.asarray(kx), jnp.asarray(vx),
                                  causal=True, window=window)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(oracle).transpose(0, 2, 1, 3),
                               **KERNEL_TOL)


@pytest.mark.parametrize("S,T,causal,window", [
    (17, 17, True, 0), (300, 300, True, 100), (5, 9, False, 0),
    (12, 12, False, 4)], ids=["ragged", "window", "cross", "band"])
def test_plain_flash_attention_any_length(S, T, causal, window):
    """No block multiple: ragged S, S != T, non-causal and banded masks
    against the oracle's dense softmax."""
    rng = np.random.RandomState(S * T)
    q = rng.randn(1, S, 6, 8).astype(np.float32)
    k = rng.randn(1, T, 2, 8).astype(np.float32)
    v = rng.randn(1, T, 2, 8).astype(np.float32)
    got = ref.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    kx = np.repeat(k, 3, axis=2).transpose(0, 2, 1, 3)
    vx = np.repeat(v, 3, axis=2).transpose(0, 2, 1, 3)
    oracle = jref.flash_attention(jnp.asarray(q.transpose(0, 2, 1, 3)),
                                  jnp.asarray(kx), jnp.asarray(vx),
                                  causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(oracle).transpose(0, 2, 1, 3),
                               **KERNEL_TOL)


def test_plain_flash_attention_keeps_bf16():
    """bf16 in, bf16 out, with the contract's one weight rounding: f32
    scores and softmax, the weights rounded to bf16 before P.V (as JAX's
    gqa_attention), P.V summed in f32 and rounded once."""
    rng = np.random.RandomState(1)
    q, k, v = (_t(rng.randn(1, 9, 4, 16).astype(np.float32)).bfloat16()
               for _ in range(3))
    got = ops.flash_attention(q, k, v)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / 4.0
    s = s.masked_fill(torch.ones(9, 9, dtype=torch.bool).triu(1), -1e30)
    w = torch.softmax(s, dim=-1).bfloat16().float()
    exp = torch.einsum("bhst,bthd->bshd", w, v.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), exp.float())


@pytest.mark.parametrize("B,S,H,K,hd,window", [
    (2, 17, 8, 2, 16, 0), (2, 65, 4, 1, 64, 0), (2, 130, 4, 4, 64, 40),
    (1, 33, 8, 8, 32, 0), (2, 47, 8, 2, 32, 9)])
def test_plain_flash_attention_bf16_matches_jax_gqa_attention(B, S, H, K, hd,
                                                              window):
    """bf16 against JAX's serving attention (``gqa_attention``, the
    ``attention_impl="xla"`` path) on the same inputs: GQA with H / K = 4
    and 1, ragged S, with and without a window.  Both round the same
    softmax weights to bf16 and the f32 P.V once, so they differ only where
    an f32 sum taken in another order rounds to the other bf16 neighbour:
    held to 2^-8 of the largest output, the least a bf16 ulp of that
    magnitude can be."""
    rng = np.random.RandomState(S + hd + window)
    q, k, v = (rng.randn(B, S, n, hd).astype(np.float32) for n in (H, K, K))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    exp = _f32(jlayers.gqa_attention(jq, jk, jv, window=window))
    got = ops.flash_attention(*(_t(np.asarray(a, np.float32)).bfloat16()
                                for a in (jq, jk, jv)), window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), exp, rtol=0,
                               atol=2.0 ** -8 * float(np.abs(exp).max()))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper's dispatch
    runs without a card (its launches go to a recording stand-in)."""
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_flash_wrapper_dispatches_on_dtype(monkeypatch):
    """On the card bf16 launches the tensor-core kernel and f32 the
    CUDA-core one, each counted; a CPU tensor runs the plain version and
    launches nothing; a device without a kernel raises."""
    launched = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: launched.append(name) or 0
    monkeypatch.setattr(ops.build, "load", Lib)
    monkeypatch.setattr(ops, "_stream_ptr", lambda dev: 0)
    rng = np.random.RandomState(3)
    q, k = (_t(rng.randn(1, 5, n, 16).astype(np.float32)) for n in (4, 2))
    for dtype, kernel, mma in ((torch.bfloat16, "flash_attention_mma_launch",
                                1),
                               (torch.float32, "flash_attention_launch", 0)):
        before = dict(ops.LAUNCHES)
        qc, kc = (t.to(dtype).as_subclass(_OnCard) for t in (q, k))
        out = ops.flash_attention(qc, kc, kc)
        assert launched[-1] == kernel == ops.FLASH_KERNELS[dtype]
        assert out.shape == q.shape and out.dtype == dtype
        assert ops.LAUNCHES["flash_attention"] == \
            before["flash_attention"] + 1
        assert ops.LAUNCHES["flash_attention_mma"] == \
            before["flash_attention_mma"] + mma
        before = dict(ops.LAUNCHES)
        plain = ops.flash_attention(q.to(dtype), k.to(dtype), k.to(dtype))
        assert ops.LAUNCHES == before, "the CPU path launched"
        torch.testing.assert_close(
            plain, ref.flash_attention(q.to(dtype), k.to(dtype), k.to(dtype)))
    assert len(launched) == 2
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:] \
        .view(q.shape).as_subclass(_OnCard)     # 2 bytes off alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(shifted, kc.to(torch.bfloat16),
                            kc.to(torch.bfloat16))
    assert len(launched) == 2
    meta = torch.empty(1, 5, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(meta, meta[:, :, :2], meta[:, :, :2])


# ------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("N,D", [(256, 64), (512, 768), (128, 96)])
def test_plain_rmsnorm_matches_pallas(N, D):
    """The shapes of tests/test_kernels.py's rmsnorm sweep."""
    rng = np.random.RandomState(N + D)
    x = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(D) * 0.1).astype(np.float32)
    before = ops.LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(_t(x), _t(w))
    assert ops.LAUNCHES["rmsnorm"] == before, "the CPU path launched"
    pallas = jops.rmsnorm(jnp.asarray(x), jnp.asarray(w), use_pallas=True)
    oracle = jref.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **KERNEL_TOL)


def test_plain_rmsnorm_flattens_leading_dims():
    """The q/k-norm shape (B, S, H, hd): rows are the leading dims."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 5, 16).astype(np.float32)
    w = (rng.randn(16) * 0.1).astype(np.float32)
    got = ops.rmsnorm(_t(x), _t(w), 1e-6)
    exp = jref.rmsnorm(jnp.asarray(x.reshape(-1, 16)), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy().reshape(-1, 16), np.asarray(exp),
                               **KERNEL_TOL)


@pytest.mark.parametrize("which", ["flash_attention", "rmsnorm"])
def test_wrapper_refuses_devices_without_a_kernel(which):
    meta = dict(device="meta")
    if which == "flash_attention":
        args = (torch.empty(1, 4, 2, 8, **meta),
                torch.empty(1, 4, 1, 8, **meta),
                torch.empty(1, 4, 1, 8, **meta))
    else:
        args = (torch.empty(3, 8, **meta), torch.empty(8, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        getattr(ops, which)(*args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [1536, 3584, 5120, 7168, 64, 130, 1, 30, 4097,
                               20000, 100_000])
@pytest.mark.parametrize("N", [1, 8, 836, 1200])
def test_rmsnorm_row_geometry_fits_every_width(N, D, dtype):
    """csrc/rmsnorm_row.cu's launch rules hold for any N and D (odd D: an
    element a unit): at most 1024 threads a CTA, a multiple of 32; a short
    row's lanes a power of two within a warp, a wide row a CTA of its
    own; every unit of a row held by one thread in at most two loads,
    except past 2 x 1024 units, where threads loop; every row covered."""
    geo = ops.rmsnorm_row_geometry(N, D, dtype)
    tpr, rows, per = (geo[k] for k in ("threads_per_row", "rows_per_cta",
                                       "per_thread"))
    assert geo["threads"] == tpr * rows <= 1024 and geo["threads"] % 32 == 0
    if tpr <= 32:
        assert tpr & (tpr - 1) == 0
    else:
        assert tpr % 32 == 0 and rows == 1
    assert geo["units"] * geo["vec"] == D
    assert geo["vec"] == (1 if D % (8 if dtype == torch.bfloat16 else 4)
                          else 16 // (2 if dtype == torch.bfloat16 else 4))
    if per:
        assert tpr * per >= geo["units"] and (per == 1 or geo["units"] > 1024)
    else:
        assert geo["units"] > 2048 and tpr == 1024
    assert geo["grid"] * rows >= N > (geo["grid"] - 1) * rows
    assert ops.rmsnorm_row_geometry(N, D, dtype, aligned=False)["vec"] == 1


@pytest.mark.parametrize("D", [1536, 3584, 5120, 7168])
def test_rmsnorm_row_geometry_at_the_served_widths(D):
    """At the served models' widths in bf16 every thread issues one
    16-byte load of x and one of w, and a row is a CTA of D / 8 threads
    (640 at mistral's 5120, 896 at zamba2's 7168)."""
    geo = ops.rmsnorm_row_geometry(8, D, torch.bfloat16)
    assert (geo["vec"], geo["per_thread"], geo["threads_per_row"],
            geo["rows_per_cta"], geo["grid"]) == (8, 1, D // 8, 1, 8)


def _rms_library(monkeypatch, rc=0):
    launched = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or rc
    monkeypatch.setattr(ops.build, "load", Lib)
    monkeypatch.setattr(ops, "_stream_ptr", lambda dev: 0)
    return launched


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 3, 64), (5, 130)])
def test_rmsnorm_wrapper_takes_the_row_kernel(monkeypatch, shape, dtype):
    """On the card every call is one launch of the row-spread kernel with
    the geometry ``rmsnorm_row_geometry`` computes (leading dims
    flattened), counted on ``rmsnorm`` and ``rmsnorm_row``; the old
    one-warp kernel is never called."""
    launched = _rms_library(monkeypatch)
    rng = np.random.RandomState(1)
    D = shape[-1]
    x = _t(rng.randn(*shape).astype(np.float32)).to(dtype)
    w = _t(rng.randn(D).astype(np.float32)).to(dtype)
    before = dict(ops.LAUNCHES)
    out = ops.rmsnorm(x.as_subclass(_OnCard), w.as_subclass(_OnCard), 1e-6)
    assert out.shape == x.shape and out.dtype == dtype
    N = x.numel() // D
    geo = ops.rmsnorm_row_geometry(N, D, dtype)
    args = (ops._DTYPES[dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            N, D, geo["vec"], geo["per_thread"], geo["threads_per_row"],
            geo["rows_per_cta"], 1e-6, 0)
    assert launched == [("rmsnorm_row_launch", args)]
    for name in ("rmsnorm", "rmsnorm_row"):
        assert ops.LAUNCHES[name] == before[name] + 1


def test_rmsnorm_launch_error_raises_without_fallback(monkeypatch):
    """A failed launch raises with its CUDA error; nothing retries on the
    old kernel and nothing is counted."""
    launched = _rms_library(monkeypatch, rc=700)
    x = torch.ones(4, 64).as_subclass(_OnCard)
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="rmsnorm_row_launch.*700"):
        ops.rmsnorm(x, torch.zeros(64).as_subclass(_OnCard))
    assert [name for name, _ in launched] == ["rmsnorm_row_launch"]
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("where", ["cpu", "empty on the card"])
def test_rmsnorm_wrapper_launches_nothing_on_cpu_or_empty(monkeypatch,
                                                          where):
    """A CPU tensor runs the plain version; no rows on the card give an
    empty result; neither launches nor counts."""
    launched = _rms_library(monkeypatch)
    x, w = torch.randn(3, 16), torch.randn(16)
    if where == "cpu":
        before = dict(ops.LAUNCHES)
        torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm(x, w))
    else:
        x, w = x[:0].as_subclass(_OnCard), w.as_subclass(_OnCard)
        before = dict(ops.LAUNCHES)
        assert ops.rmsnorm(x, w).shape == (0, 16)
    assert launched == [] and ops.LAUNCHES == before


# ------------------------------------------------------------ lm_prefill
PREFILL_CASES = {"dense": (DENSE, None), "moe-dropless": (MOE, "dropless"),
                 "moe-capacity": (MOE, "capacity")}


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_lm_prefill_matches_jax(name):
    arch, routing = PREFILL_CASES[name]
    jcfg, tcfg = _configs(arch, routing)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    tparams = _bridge(jparams)
    toks = np.random.RandomState(5).randint(
        1, jcfg.vocab - 1, size=(3, 13)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks))
    tl, tc = build_model(tcfg).prefill(tparams, _t(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    for k in ("k", "v"):
        assert tc[k].shape == jc[k].shape == (2, 3, 13, 2, 16)
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **STEP_TOL)
    assert int(tc["cur"]) == int(jc["cur"]) == 13


def test_lm_prefill_refuses_sliding_window_by_name():
    """The exact-length prefill takes a window, on both planes (the dense
    one packs a ring of window rows); bucketed prefill (``valid_len``)
    does not, and is refused with JAX's words."""
    _, tcfg = _configs(sliding_window=8)
    params = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    _, cache = ttr.lm_prefill(params, tcfg,
                              torch.ones((1, 9), dtype=torch.int32),
                              max_len=16)
    assert cache["k"].shape[2] == 8 and cache["pos"].shape == (8,)
    with pytest.raises(ValueError, match="without a sliding window"):
        ttr.lm_prefill(params, tcfg, torch.ones((1, 9), dtype=torch.int32),
                       max_len=16, valid_len=7)


# ------------------------------------------------------------ page write
@pytest.mark.parametrize("skip", [0, 8], ids=["whole", "skip-one-block"])
def test_paged_prefill_write_matches_jax(skip):
    jcfg, tcfg = _configs()
    rng = np.random.RandomState(skip + 1)
    L, G, S, K, hd, bt = 2, 2, 19, 2, 16, 8
    P = 9
    nb = -(-S // bt) - skip // bt
    k_rows = rng.randn(L, G, S, K, hd).astype(np.float32)
    v_rows = rng.randn(L, G, S, K, hd).astype(np.float32)
    ids = rng.permutation(P - 1)[:G * nb].astype(np.int32)
    kp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    vp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    jpages = jax_write(jcfg, {"kp": jnp.asarray(kp0), "vp": jnp.asarray(vp0)},
                       jnp.asarray(k_rows), jnp.asarray(v_rows),
                       jnp.asarray(ids), S, skip)
    tpages = {"kp": _t(kp0).clone(), "vp": _t(vp0).clone()}
    out = ttr.lm_paged_prefill_write(tcfg, tpages, _t(k_rows), _t(v_rows),
                                     _t(ids), S, skip)
    assert out["kp"] is tpages["kp"], "arena must update in place"
    for k in ("kp", "vp"):
        np.testing.assert_array_equal(tpages[k].numpy()[:, :P - 1],
                                      np.asarray(jpages[k])[:, :P - 1])


@pytest.mark.parametrize("skip,window,T,words", [
    (3, 0, 19, "block-aligned"), (24, 0, 19, "block-aligned"),
    (8, 8, 8, "ring-packed")], ids=["unaligned", "past-prompt", "ring"])
def test_paged_prefill_write_errors_as_jax(skip, window, T, words):
    jcfg, tcfg = _configs(sliding_window=window)
    k_rows = np.zeros((2, 1, T, 2, 16), np.float32)
    ids = np.arange(2, dtype=np.int32)
    pages = ttr.lm_init_paged_cache(tcfg, 1, 24, 8, device="cpu")
    with pytest.raises(ValueError, match=words) as tex:
        ttr.lm_paged_prefill_write(tcfg, pages, _t(k_rows), _t(k_rows),
                                   _t(ids), 19, skip)
    jpages = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pages)
    with pytest.raises(ValueError, match=words) as jex:
        jtr.lm_paged_prefill_write(jcfg, jpages, jnp.asarray(k_rows),
                                   jnp.asarray(k_rows), jnp.asarray(ids), 19,
                                   skip)
    assert str(tex.value) == str(jex.value)


# ------------------------------------------------------------ engine
def _trace(vocab=128):
    """The ragged lengths of tests/test_differential.py's _trace."""
    rng = np.random.RandomState(4321)
    lens_new = [(4, 4), (9, 1), (16, 3), (1, 5), (27, 4), (5, 2), (13, 3)]
    return [(rng.randint(1, vocab - 1, size=n).tolist(), m)
            for n, m in lens_new]


def _grouped_trace(vocab=128):
    """Equal prompt lengths back to back, so prefill_batch groups form."""
    rng = np.random.RandomState(77)
    return [(rng.randint(1, vocab - 1, size=n).tolist(), m)
            for n, m in [(6, 3)] * 4 + [(11, 2)] * 3 + [(6, 4), (20, 3)]]


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


# the one-shot rows of tests/test_differential.py; capacity-routed MoE
# serves one-shot under auto
ENGINES = {
    "paged-oneshot": (DENSE, None, dict(prefill_chunk=0)),
    "paged-oneshot-pfb4": (DENSE, None, dict(prefill_chunk=0,
                                             prefill_batch=4)),
    "moe-oneshot": (MOE, "dropless", dict(prefill_chunk=0)),
    "moe-oneshot-pfb4": (MOE, "dropless", dict(prefill_chunk=0,
                                               prefill_batch=4)),
    "moe-capacity-auto": (MOE, "capacity", dict()),
    "moe-capacity-auto-pfb4": (MOE, "capacity", dict(prefill_batch=4)),
}


@pytest.fixture(scope="module")
def engine_params():
    out = {}
    for arch, routing in ((DENSE, None), (MOE, "dropless"),
                          (MOE, "capacity")):
        jcfg, tcfg = _configs(arch, routing)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(3))
        out[arch, routing] = (jmodel, jparams, build_model(tcfg),
                              _bridge(jparams))
    return out


# every plane on the ragged trace; the prefill_batch 4 planes also on a
# trace whose equal-length neighbours form admission groups
ENGINE_RUNS = [(plane, "ragged") for plane in sorted(ENGINES)] + \
    [(plane, "grouped") for plane in sorted(ENGINES) if "pfb4" in plane]


@pytest.mark.parametrize("plane,trace_name", ENGINE_RUNS,
                         ids=[f"{p}-{t}" for p, t in ENGINE_RUNS])
def test_engine_wire_outputs_match_jax(engine_params, plane, trace_name):
    arch, routing, kw = ENGINES[plane]
    jmodel, jparams, tmodel, tparams = engine_params[arch, routing]
    trace = (_trace if trace_name == "ragged" else _grouped_trace)(
        jmodel.cfg.vocab)
    bufs = [encode_request(i, p, m) for i, (p, m) in enumerate(trace)]
    slots = 3 if trace_name == "ragged" else 4
    jsrv = JaxBatchServer(jmodel, batch_slots=slots, max_len=MAX_LEN,
                          params=jparams, nic_cost=None, **kw)
    tsrv = BatchServer(tmodel, batch_slots=slots, max_len=MAX_LEN,
                       params=tparams, device="cpu", nic_cost=None, **kw)
    assert tsrv.prefill_chunk == jsrv.prefill_chunk == 0
    calls = []
    prefill = tsrv._prefill_exact
    tsrv._prefill_exact = lambda p, t: calls.append(t.shape[0]) \
        or prefill(p, t)
    for buf in bufs:
        jsrv.submit_wire(buf)
        tsrv.submit_wire(buf)
    jout = jsrv.run_until_drained()
    tout = tsrv.run_until_drained()
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert sorted(tout) == sorted(jout)          # byte-identical responses
    assert len(tout) == len(trace) and tsrv.stats["failed"] == 0
    assert tsrv.kv_stats()["paged"]["pages_in_use"] == 0, "leaked pages"
    for key in ("prefills", "decode_steps", "prefill_chunks", "admitted"):
        assert tsrv.stats[key] == jsrv.stats[key], key
    assert sum(calls) == len(trace)
    assert max(calls) <= tsrv.prefill_batch
    if trace_name == "grouped":
        assert max(calls) == 4, "no full admission group formed"


def test_engine_fails_empty_and_overlong_prompts(engine_params):
    jmodel, jparams, tmodel, tparams = engine_params[DENSE, None]
    trace = [([], 2), ([5] * (MAX_LEN + 1), 2), ([7, 8, 9], 2)]
    jsrv = JaxBatchServer(jmodel, batch_slots=2, max_len=MAX_LEN,
                          params=jparams, nic_cost=None, prefill_chunk=0)
    tsrv = BatchServer(tmodel, batch_slots=2, max_len=MAX_LEN,
                       params=tparams, device="cpu", nic_cost=None,
                       prefill_chunk=0)
    for i, (p, m) in enumerate(trace):
        jsrv.submit(JaxRequest(i, p, m))
        tsrv.submit(Request(i, p, m))
    jout = _outs(jsrv.run_until_drained(), jwire)
    tout = _outs(tsrv.run_until_drained(), wire)
    assert tout == jout and tout[0] == tout[1] == []
    assert tsrv.stats["failed"] == jsrv.stats["failed"] == 2


def test_decode_timer_counts_the_pagers_host_work(engine_params):
    """decode_wall_s opens before the loop of ``pager.advance`` calls, as
    JAX's does: host time spent there is decode time.  With 50 ms of
    sleep in each call the window must hold at least that much per step
    (the model step itself takes a few ms here)."""
    _, _, tmodel, tparams = engine_params[DENSE, None]
    srv = BatchServer(tmodel, batch_slots=2, max_len=MAX_LEN, params=tparams,
                      device="cpu", nic_cost=None, prefill_chunk=0)
    srv.submit_wire(encode_request(0, [3, 4, 5], 5))
    advance = srv.pager.advance
    calls = []

    def slow(slot, tokens):
        calls.append(slot)
        time.sleep(0.05)
        return advance(slot, tokens)
    srv.pager.advance = slow
    srv.run_until_drained()
    assert srv.stats["decode_steps"] == len(calls) == 4
    assert srv.stats["decode_wall_s"] >= 0.05 * len(calls)


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("argv", [
    ["--prefill-chunk", "0"],
    ["--arch", MOE, "--moe-routing", "capacity"],
    ["--arch", MOE, "--moe-routing", "capacity", "--prefill-chunk", "0"],
], ids=["dense-oneshot", "moe-capacity", "moe-capacity-explicit"])
def test_launcher_serves_oneshot_on_cpu(argv, capsys):
    out = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                      "--prompt-len", "9", "--max-new", "3", *argv])
    assert len(out) == 3
    text = capsys.readouterr().out
    assert "3/3 completed" in text and "'prefill_chunks': 0" in text


def test_launcher_refuses_capacity_with_a_chunk_as_jax(capsys):
    with pytest.raises(SystemExit) as ex:
        serve.main(["--device", "cpu", "--arch", MOE, "--moe-routing",
                    "capacity", "--prefill-chunk", "8"])
    assert ex.value.code == 2
    assert "chunk-invariant" in capsys.readouterr().err


# ------------------------------------------------------------ bf16
def test_bf16_steps_match_jax():
    """One bf16 one-shot prefill, one chunk step and one decode step of
    tiny dense against JAX at the north star's 2e-2 (normwise, see
    ``_assert_bf16_close``)."""
    jcfg, tcfg = _configs(dtypes=BF16)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    tparams = _bridge(jparams, torch.bfloat16)
    assert tparams["emb"].dtype == torch.bfloat16
    rng = np.random.RandomState(12)
    toks = rng.randint(1, jcfg.vocab - 1, size=(2, 11)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks))
    tl, tc = ttr.lm_prefill(tparams, tcfg, _t(toks))
    assert tl.dtype == torch.bfloat16
    _assert_bf16_close(tl, jl)
    for k in ("k", "v"):
        _assert_bf16_close(tc[k], jc[k])

    B, bt, nb, C = 2, 8, 4, 8
    L, K, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    P = B * nb + 1
    kp0 = (rng.randn(L, P, bt, K, hd) * 0.5).astype(np.float32)
    vp0 = (rng.randn(L, P, bt, K, hd) * 0.5).astype(np.float32)
    btab = rng.permutation(P - 1)[:B * nb].reshape(B, nb).astype(np.int32)
    ctx = np.array([9, 0], np.int32)
    valid = np.array([8, 6], np.int32)
    ctoks = rng.randint(1, jcfg.vocab - 1, size=(B, C)).astype(np.int32)
    jpages = {"kp": jnp.asarray(kp0, jnp.bfloat16),
              "vp": jnp.asarray(vp0, jnp.bfloat16)}
    tpages = {"kp": _t(kp0).bfloat16(), "vp": _t(vp0).bfloat16()}
    jl, jpages = jax_chunk(jparams, jcfg, jpages, jnp.asarray(ctoks),
                           jnp.asarray(btab), jnp.asarray(ctx),
                           jnp.asarray(valid))
    tl, _ = ttr.lm_paged_prefill_chunk(tparams, tcfg, tpages, _t(ctoks),
                                       _t(btab), _t(ctx), _t(valid))
    _assert_bf16_close(tl, jl)
    lens = ctx + valid
    last = rng.randint(1, jcfg.vocab - 1, size=(B, 1)).astype(np.int32)
    jl, jpages = jax_decode(jparams, jcfg, jpages, jnp.asarray(last),
                            jnp.asarray(btab), jnp.asarray(lens))
    tl, _ = ttr.lm_paged_decode_step(tparams, tcfg, tpages, _t(last),
                                     _t(btab), _t(lens))
    _assert_bf16_close(tl, jl)
    for k in ("kp", "vp"):
        _assert_bf16_close(_f32(tpages[k])[:, :P - 1],
                           _f32(jpages[k])[:, :P - 1])


@pytest.mark.parametrize("top_k", [2, 8])
def test_bf16_moe_combine_within_its_rounding_bound(top_k):
    """bf16 MoE layer against JAX under the port's combine contract.

    JAX combines with a bf16 ``.at[].add``, rounding after every add, so
    its sum depends on the order of the adds; the port sums each row in
    f32 and rounds once.  A row of ``top_k`` gated expert outputs takes
    ``top_k`` adds onto zero: the first is exact and each later one rounds
    once more, so the two differ by at most ``top_k * 2^-8 * max|row|``
    (bf16 keeps 8 significant bits).  At top-2 the one rounded add is the
    port's single rounding, so the two agree exactly; granite serves
    top-8.  Everything before the combine (router, top-k, expert GEMMs)
    sums in f32 in both and rounds once.
    """
    jcfg, tcfg = _configs(MOE, "dropless", dtypes=BF16, top_k=top_k)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    mp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    tp = _bridge(mp, torch.bfloat16)
    x = np.random.RandomState(8).randn(2, 9, jcfg.d_model).astype(np.float32)
    jy = _f32(jmoe.moe_apply(mp, jnp.asarray(x, jnp.bfloat16), jcfg))
    ty = _f32(tmoe.moe_apply(tp, _t(x).bfloat16(), tcfg))
    bound = top_k * 2.0 ** -8 * np.abs(ty).max(-1, keepdims=True)
    diff = np.abs(ty - jy)
    assert (diff <= bound).all(), float((diff - bound).max())
    if top_k == 2:
        np.testing.assert_array_equal(ty, jy)
    _assert_bf16_close(ty, jy)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,H,K,hd,window", [
    (17, 32, 8, 128, 0), (300, 32, 8, 128, 100), (64, 24, 8, 64, 0),
    (300, 24, 8, 64, 0)])
def test_flash_kernel_matches_plain_on_card(cuda, S, H, K, hd, window,
                                            dtype, tol):
    rng = np.random.RandomState(S + hd)
    q, k, v = (_t(rng.randn(2, S, n, hd).astype(np.float32)).to(cuda, dtype)
               for n in (H, K, K))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(
        got.float(), ref.flash_attention(q, k, v, window=window).float(),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,T,H,K,hd,window,causal", [
    (4, 209, 209, 32, 8, 128, 0, True), (4, 189, 189, 32, 32, 112, 0, True),
    (4, 209, 209, 24, 8, 64, 0, True), (1, 17, 17, 32, 8, 128, 0, True),
    (4, 300, 300, 32, 8, 128, 100, True), (2, 77, 150, 32, 8, 128, 0, False),
    (2, 150, 77, 32, 8, 128, 0, True), (1, 33, 33, 4, 2, 40, 0, True)])
def test_flash_mma_kernel_matches_plain_on_card(cuda, B, S, T, H, K, hd,
                                                window, causal):
    """The bf16 tensor-core kernel at the served models' group-call shapes
    (mistral, zamba2, granite), a ragged S, a window, S != T causal and
    not, and a head dim padded to 16 (40), within the north star's 2e-2
    of the plain version; the launch is counted as flash_attention and as
    its mma variant."""
    rng = np.random.RandomState(S + T + hd)
    q = _t(rng.randn(B, S, H, hd).astype(np.float32)).to(cuda, torch.bfloat16)
    k, v = (_t(rng.randn(B, T, K, hd).astype(np.float32))
            .to(cuda, torch.bfloat16) for _ in range(2))
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_mma"] == \
        before["flash_attention_mma"] + 1
    torch.testing.assert_close(
        got.float(),
        ref.flash_attention(q, k, v, causal=causal, window=window).float(),
        atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,D", [(1, 5120), (8, 1536), (1200, 5120),
                                 (37, 64), (5, 30), (8, 7168), (836, 3584),
                                 (1200, 130), (3, 20000), (8, 1)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, N, D, dtype, tol):
    """The row-spread kernel at the served widths (decode and prefill row
    counts), short rows that share a CTA, odd D (an element a unit) and a
    row too long for registers (20000: the strided loop)."""
    rng = np.random.RandomState(N + D)
    x = _t(rng.randn(N, D).astype(np.float32)).to(cuda, dtype)
    w = _t((rng.randn(D) * 0.1).astype(np.float32)).to(cuda, dtype)
    before = dict(ops.LAUNCHES)
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    for name in ("rmsnorm", "rmsnorm_row"):
        assert ops.LAUNCHES[name] == before[name] + 1
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, w).float(),
                               atol=tol, rtol=tol)
