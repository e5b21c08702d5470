"""The port's MoE slice against the JAX reference: the plain versions of
the two MoE kernels, ``moe_apply``, the paged steps and the engine of a
tiny dropless granite-moe, and the errors of capacity routing with a
chunk.

Inputs come from fixed numpy seeds and go to both frameworks as numpy
arrays.  Tolerances: the plain kernels and ``moe_apply`` within 1e-5 at
f32 (sums in torch's order, not XLA's); the model steps within 1e-4, as
the dense slice's (``tests/test_torch_model.py``); the engines' greedy
wire outputs identical.  The ``rao_scatter`` Pallas kernel does not run
on the installed JAX, so the port's scatter-add is held against
``repro.kernels.ref.rao_scatter_add``.  The hand-written CUDA kernels
are held against the plain versions on the card (skipped without one).
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
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.model import build_model as jax_build_model
from repro.runtime.server import BatchServer as JaxBatchServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import schema_leaves
from repro_torch.models.model import build_model
from repro_torch.runtime.server import BatchServer, encode_request

ARCH = "granite-moe-3b-a800m"
F32 = dict(param_dtype="float32", cache_dtype="float32")
# the _tiny overrides of tests/test_differential.py (reduced granite keeps
# 8 experts, top-2, d_ff_expert 64)
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128)
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32
jax_chunk = jax.jit(jtr.lm_paged_prefill_chunk, static_argnums=(1,))
jax_decode = jax.jit(jtr.lm_paged_decode_step, static_argnums=(1,))


def _configs(routing="dropless", **over):
    over = dict(TINY, moe_routing=routing, **F32, **over)
    return (jax_reduced(jax_get_config(ARCH)).replace(**over),
            reduced(get_config(ARCH)).replace(**over))


def _bridge(jparams):
    return params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
        "cpu", torch.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ moe_gmm
GMM_SHAPES = [
    (8, 48, 64, 64),      # dropless C = Tl: capacity not block-aligned
    (3, 200, 96, 72),     # every tile dim ragged
    (2, 1, 64, 128),      # single-row capacity (decode-sized dispatch)
    (5, 130, 130, 130),   # just past one block on every dim
]
GMM_EMPTY = [(0, 16, 8, 8), (4, 0, 8, 8), (2, 16, 8, 0)]


@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES + GMM_EMPTY)
def test_plain_moe_gmm_matches_jax(E, C, D, F):
    """The plain version against the Pallas kernel (interpret mode) and
    the jnp oracle, ragged and zero-size shapes included."""
    rng = np.random.RandomState(E * 1000 + C + D + F)
    xe = rng.randn(E, C, D).astype(np.float32)
    w = (rng.randn(E, D, F) / np.sqrt(max(D, 1))).astype(np.float32)
    before = ops.LAUNCHES["moe_gmm"]
    got = ops.moe_gmm(_t(xe), _t(w))
    assert got.shape == (E, C, F) and got.dtype == torch.float32
    assert ops.LAUNCHES["moe_gmm"] == before, "the CPU path launched"
    pallas = np.asarray(jops.moe_gmm(jnp.asarray(xe), jnp.asarray(w)))
    oracle = np.asarray(jref.moe_gmm(jnp.asarray(xe), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), pallas, **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **KERNEL_TOL)


def test_plain_moe_gmm_casts_to_the_input_dtype():
    rng = np.random.RandomState(2)
    xe = _t(rng.randn(2, 5, 16).astype(np.float32)).bfloat16()
    w = _t(rng.randn(2, 16, 8).astype(np.float32)).bfloat16()
    got = ops.moe_gmm(xe, w)
    assert got.dtype == torch.bfloat16
    exp = torch.einsum("ecd,edf->ecf", xe.float(), w.float())
    torch.testing.assert_close(got.float(), exp.bfloat16().float())


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper's dispatch
    runs without a card (its launches go to a recording stand-in)."""
    @property
    def device(self):
        return torch.device("cuda", 0)


def _recording_library(monkeypatch, rc=0):
    """Stand in for the kernel library: every launch is recorded as
    (function name, arguments) and returns ``rc``."""
    launched = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or rc
    monkeypatch.setattr(ops.build, "load", Lib)
    monkeypatch.setattr(ops, "_stream_ptr", lambda dev: 0)
    return launched


def _gmm_operands(case):
    """(2, 5, 16) x (2, 16, 24) bf16, or the one change ``case`` names."""
    rng = np.random.RandomState(11)
    E, C, D, F = 2, 5, 16, 24
    D = 130 if case == "bf16 D 130" else D
    F = 130 if case == "bf16 F 130" else F
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    xe = _t(rng.randn(E, C, D).astype(np.float32)).to(dtype)
    w = _t(rng.randn(E, D, F).astype(np.float32)).to(dtype)
    if case == "bf16 2-byte offset":     # contiguous, 2 bytes off alignment
        xe = torch.zeros(xe.numel() + 1, dtype=dtype)[1:].view(xe.shape) \
            .copy_(xe)
    return xe, w


@pytest.mark.parametrize("case,kernel", [
    ("bf16 aligned", "moe_gmm_wgmma_launch"),
    ("bf16 D 130", "moe_gmm_launch"),
    ("bf16 F 130", "moe_gmm_launch"),
    ("bf16 2-byte offset", "moe_gmm_launch"),
    ("f32", "moe_gmm_launch")])
def test_moe_gmm_wrapper_routes_by_dtype_shape_and_alignment(monkeypatch,
                                                             case, kernel):
    """On the card, bf16 with D and F multiples of 8 and 16-byte aligned
    bases (TMA's rules) launches the TMA / wgmma kernel, counted on
    ``moe_gmm`` and ``moe_gmm_wgmma``; another bf16 shape, a misaligned
    base or f32 launches ``csrc/moe_gmm.cu``, counted on ``moe_gmm``
    only.  ``ops.moe_gmm_kernel`` states the rule."""
    launched = _recording_library(monkeypatch)
    xe, w = _gmm_operands(case)
    assert ops.moe_gmm_kernel(xe, w) == kernel
    before = dict(ops.LAUNCHES)
    out = ops.moe_gmm(xe.as_subclass(_OnCard), w.as_subclass(_OnCard))
    E, C, D = xe.shape
    F = w.shape[2]
    assert out.shape == (E, C, F) and out.dtype == xe.dtype
    args = (xe.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F, 0)
    if kernel == "moe_gmm_launch":
        args = (ops._DTYPES[xe.dtype],) + args
    assert launched == [(kernel, args)]
    wgmma = int(kernel == "moe_gmm_wgmma_launch")
    assert ops.LAUNCHES["moe_gmm"] == before["moe_gmm"] + 1
    assert ops.LAUNCHES["moe_gmm_wgmma"] == before["moe_gmm_wgmma"] + wgmma


@pytest.mark.parametrize("where", ["cpu", "zero C on the card",
                                   "zero F on the card"])
def test_moe_gmm_wrapper_launches_nothing_on_cpu_or_empty(monkeypatch,
                                                          where):
    """A CPU tensor runs the plain version; a zero-size operand gives the
    empty or all-zero result; neither launches nor counts."""
    launched = _recording_library(monkeypatch)
    xe, w = _gmm_operands("bf16 aligned")
    if where == "zero C on the card":
        xe = xe[:, :0]
    elif where == "zero F on the card":
        w = w[:, :, :0].contiguous()
    if where != "cpu":
        xe, w = xe.as_subclass(_OnCard), w.as_subclass(_OnCard)
    before = dict(ops.LAUNCHES)
    out = ops.moe_gmm(xe, w)
    assert launched == [] and ops.LAUNCHES == before
    assert out.shape == (xe.shape[0], xe.shape[1], w.shape[2])
    out, xe, w = (t.as_subclass(torch.Tensor) for t in (out, xe, w))
    torch.testing.assert_close(out, ref.moe_gmm(xe, w))


def test_moe_gmm_launch_error_raises_without_fallback(monkeypatch):
    """A failed launch raises with its CUDA error; nothing retries on the
    other kernel and nothing is counted."""
    launched = _recording_library(monkeypatch, rc=700)
    xe, w = (t.as_subclass(_OnCard) for t in _gmm_operands("bf16 aligned"))
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="moe_gmm_wgmma_launch.*700"):
        ops.moe_gmm(xe, w)
    assert [name for name, _ in launched] == ["moe_gmm_wgmma_launch"]
    assert ops.LAUNCHES == before


# ------------------------------------------------------------ rao
@pytest.mark.parametrize("N,D,M", [(16, 8, 128), (64, 16, 256), (8, 4, 128),
                                   (513, 24, 320)])
def test_plain_rao_scatter_add_matches_jax_oracle(N, D, M):
    """Heavy duplicate indices — the atomic-accumulation contract."""
    rng = np.random.RandomState(N + D + M)
    table = rng.randn(N, D).astype(np.float32)
    idx = rng.randint(0, N, size=M).astype(np.int32)
    vals = rng.randn(M, D).astype(np.float32)
    before = ops.LAUNCHES["rao_scatter_add"]
    got = ops.rao_scatter_add(_t(table), _t(idx), _t(vals))
    assert ops.LAUNCHES["rao_scatter_add"] == before, "the CPU path launched"
    exp = np.asarray(jref.rao_scatter_add(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals)))
    np.testing.assert_allclose(got.numpy(), exp, **KERNEL_TOL)
    np.testing.assert_allclose(ref.rao_scatter_add(
        _t(table), _t(idx), _t(vals)).numpy(), exp, **KERNEL_TOL)


def test_plain_rao_scatter_central_pattern():
    """CENTRAL: every update hits one row (the paper's lock-service case)."""
    table = np.zeros((4, 8), np.float32)
    idx = np.zeros((256,), np.int32)
    vals = np.ones((256, 8), np.float32)
    got = ops.rao_scatter_add(_t(table), _t(idx), _t(vals)).numpy()
    exp = np.asarray(jref.rao_scatter_add(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals)))
    np.testing.assert_allclose(got, exp, **KERNEL_TOL)
    assert got[0, 0] == 256.0 and not np.abs(got[1:]).sum()


def test_plain_rao_scatter_add_leaves_its_input_alone():
    table = torch.zeros(3, 2)
    out = ref.rao_scatter_add(table, torch.tensor([1, 1], dtype=torch.int32),
                              torch.ones(2, 2))
    assert not table.any() and out[1].tolist() == [2.0, 2.0]


@pytest.mark.parametrize("which", ["moe_gmm", "rao_scatter_add"])
def test_wrapper_refuses_devices_without_a_kernel(which):
    meta = dict(device="meta")
    if which == "moe_gmm":
        args = (torch.empty(2, 4, 8, **meta), torch.empty(2, 8, 6, **meta))
    else:
        args = (torch.empty(5, 8, **meta),
                torch.empty(4, dtype=torch.int32, **meta),
                torch.empty(4, 8, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        getattr(ops, which)(*args)


def _check_rao_geometry(N, M, D, geo):
    """The limits of one launch of csrc/rao_scatter_onchip.cu: a CTA's
    threads and shared memory, the cluster size, the grid's bounds, and
    every row, column and update covered."""
    lanes = geo["cols"] // geo["vec"]
    row_tiles, col_tiles = geo["grid"][0] // geo["split"], geo["grid"][1]
    assert geo["grid"][0] % geo["split"] == 0
    assert geo["threads"] == (256 if M < ops.RAO_WIDE_M else 512)
    assert geo["threads"] % lanes == 0
    assert lanes & (lanes - 1) == 0 and geo["cols"] % 32 == 0
    assert 1 <= geo["split"] <= 8
    assert geo["smem"] == 4 * geo["rows"] * geo["cols"]
    assert geo["smem"] <= ops.rao_slab_bytes(geo["threads"]) <= \
        ops.SMEM_LIMIT
    per_sm = 3 if geo["threads"] == 256 else 2     # by registers, threads
    assert per_sm * (geo["smem"] + ops.SM_SMEM_RESERVED) <= ops.SM_SMEM
    assert row_tiles * geo["rows"] >= N > (row_tiles - 1) * geo["rows"]
    assert col_tiles * geo["cols"] >= D > (col_tiles - 1) * geo["cols"]
    assert col_tiles <= 65535 and geo["grid"][0] < 2 ** 31
    assert geo["split"] * geo["per_cta"] >= M
    assert geo["ctas"] == geo["grid"][0] * geo["grid"][1]
    assert geo["vec"] == (8 if D % 8 == 0 else 1)


@pytest.mark.parametrize("N,M,threads", [
    (9, 320, 256),            # decode: 8 tokens and the pad row
    (513, 20480, 512),        # the largest dropless chunk tick
    (837, 8360, 512)],        # the one-shot capacity group call (C 209)
    ids=["decode", "max-tick", "oneshot-group"])
def test_rao_onchip_geometry_at_the_main_path(N, M, threads):
    """granite's three combine shapes (D 1536) take one launch of the
    on-chip kernel: 16-byte loads, every row in one slab (600 rows at
    256 threads, 904 at 512), clusters of 4, 192 CTAs: about 1.5 an SM."""
    geo = ops.rao_scatter_onchip_geometry(N, M, 1536)
    _check_rao_geometry(N, M, 1536, geo)
    assert (geo["vec"], geo["threads"], geo["cols"], geo["rows"],
            geo["split"], geo["ctas"]) == (8, threads, 32, N, 4, 192)
    assert geo["ctas"] <= ops.RAO_GRID_CTAS


@pytest.mark.parametrize("N", [1, 600, 601, 904, 905, 5000, 100_000,
                               1 << 22])
@pytest.mark.parametrize("M,D", [(1, 1536), (20481, 1536), (7, 130),
                                 (3000, 8), (50, 70000)])
def test_rao_onchip_geometry_fits_any_shape(N, M, D):
    """Any N (far above 837: tiled rows), M (not a multiple of any block)
    and D (odd: a column a lane) fits one launch."""
    geo = ops.rao_scatter_onchip_geometry(N, M, D)
    _check_rao_geometry(N, M, D, geo)
    assert ops.rao_scatter_onchip_geometry(N, M, D, aligned=False)["vec"] \
        == 1


def test_rao_kernel_table_and_binding():
    """bf16 takes the on-chip kernel, f32 the atomic one; both sources are
    built; the on-chip launcher takes three pointers, N, M (64-bit), D,
    vec, cols, rows, split, threads and the stream."""
    assert ops.RAO_KERNELS == {
        torch.bfloat16: "rao_scatter_add_onchip_launch",
        torch.float32: "rao_scatter_add_launch"}
    for src in ("rao_scatter.cu", "rao_scatter_onchip.cu"):
        assert src in ops.build.SOURCES and (ops.build.CSRC / src).is_file()

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn
    lib = ops.build._bind(Lib())
    c = ops.build.ctypes
    p, i = c.c_void_p, c.c_int
    assert lib.rao_scatter_add_onchip_launch.argtypes == \
        [p, p, p, i, c.c_longlong] + [i] * 6 + [p]
    assert lib.rao_scatter_add_onchip_launch.restype == i


def _rao_operands(case, N=9, M=20, D=16):
    rng = np.random.RandomState(5)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    D = 13 if case == "bf16 D 13" else D
    table = _t(rng.randn(N, D).astype(np.float32)).to(dtype)
    idx = _t(rng.randint(0, N, size=M).astype(np.int32))
    vals = _t(rng.randn(M, D).astype(np.float32)).to(dtype)
    if case == "bf16 2-byte offset":    # contiguous, 2 bytes off alignment
        vals = torch.zeros(vals.numel() + 1, dtype=dtype)[1:] \
            .view(vals.shape).copy_(vals)
    return table, idx, vals


def _no_allocation(monkeypatch):
    """Make every tensor allocation the wrapper could reach raise."""
    def boom(*a, **kw):
        raise AssertionError("rao_scatter_add allocated a tensor")
    for name in ("empty", "zeros", "empty_like", "zeros_like", "full",
                 "ones"):
        monkeypatch.setattr(torch, name, boom)
    for name in ("new_empty", "new_zeros", "new_full"):
        monkeypatch.setattr(torch.Tensor, name, boom)


@pytest.mark.parametrize("case", ["bf16 aligned", "bf16 D 13",
                                  "bf16 2-byte offset", "f32"])
def test_rao_wrapper_is_one_launch_without_scratch(monkeypatch, case):
    """On the card a bf16 call is one launch of the on-chip kernel with the
    geometry ``rao_scatter_onchip_geometry`` computes (a column a lane
    where D or a base rules out 16-byte loads), counted on
    ``rao_scatter_add`` and ``rao_scatter_add_onchip``; f32 is one launch
    of the atomic kernel with no scratch.  Neither allocates."""
    launched = _recording_library(monkeypatch)
    table, idx, vals = _rao_operands(case)
    N, D = table.shape
    M = idx.shape[0]
    before = dict(ops.LAUNCHES)
    _no_allocation(monkeypatch)
    got = ops.rao_scatter_add(*(t.as_subclass(_OnCard)
                                for t in (table, idx, vals)))
    assert got.data_ptr() == table.data_ptr()
    ptrs = (table.data_ptr(), idx.data_ptr(), vals.data_ptr())
    onchip = case != "f32"
    if onchip:
        geo = ops.rao_scatter_onchip_geometry(
            N, M, D, case == "bf16 aligned")
        assert geo["vec"] == (8 if case == "bf16 aligned" else 1)
        args = ptrs + (N, M, D, geo["vec"], geo["cols"], geo["rows"],
                       geo["split"], geo["threads"], 0)
        assert launched == [("rao_scatter_add_onchip_launch", args)]
    else:
        assert launched == [("rao_scatter_add_launch",
                             (0,) + ptrs + (None, N, M, D, 0))]
    assert ops.LAUNCHES["rao_scatter_add"] == before["rao_scatter_add"] + 1
    assert ops.LAUNCHES["rao_scatter_add_onchip"] == \
        before["rao_scatter_add_onchip"] + onchip


@pytest.mark.parametrize("where", ["cpu", "zero M on the card",
                                   "zero N on the card"])
def test_rao_wrapper_launches_nothing_on_cpu_or_empty(monkeypatch, where):
    """A CPU tensor runs the plain version; an empty table or no updates
    return the table itself; none launches or counts."""
    launched = _recording_library(monkeypatch)
    table, idx, vals = _rao_operands("bf16 aligned")
    if where == "zero M on the card":
        idx, vals = idx[:0], vals[:0]
    elif where == "zero N on the card":
        table = table[:0]
    before = dict(ops.LAUNCHES)
    if where == "cpu":
        got = ops.rao_scatter_add(table, idx, vals)
        torch.testing.assert_close(got, ref.rao_scatter_add(table, idx, vals))
    else:
        args = [t.as_subclass(_OnCard) for t in (table, idx, vals)]
        assert ops.rao_scatter_add(*args) is args[0]
    assert launched == [] and ops.LAUNCHES == before


def test_rao_launch_error_raises_without_fallback(monkeypatch):
    """A failed launch of the on-chip kernel raises with its CUDA error;
    nothing retries on the atomic kernel and nothing is counted."""
    launched = _recording_library(monkeypatch, rc=700)
    args = [t.as_subclass(_OnCard) for t in _rao_operands("bf16 aligned")]
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError,
                       match="rao_scatter_add_onchip_launch.*700"):
        ops.rao_scatter_add(*args)
    assert [name for name, _ in launched] == ["rao_scatter_add_onchip_launch"]
    assert ops.LAUNCHES == before


# ------------------------------------------------------------ moe_apply
@pytest.mark.parametrize("routing", ["dropless", "capacity"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("aux", [False, True], ids=["out", "aux"])
def test_moe_apply_matches_jax(routing, G, aux):
    jcfg, tcfg = _configs(routing)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(5))
    layer0 = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tp = _bridge(layer0)
    x = np.random.RandomState(G + 7).randn(3, 6, jcfg.d_model) \
        .astype(np.float32)
    jout = jmoe.moe_apply(layer0, jnp.asarray(x), jcfg, return_aux=aux,
                          n_groups=G)
    tout = tmoe.moe_apply(tp, _t(x), tcfg, return_aux=aux, n_groups=G)
    if aux:
        (jout, jaux), (tout, taux) = jout, tout
        assert sorted(taux) == sorted(jaux)
        for k in jaux:
            np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                       **KERNEL_TOL)
    assert tout.shape == x.shape
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **KERNEL_TOL)


def test_moe_apply_dropless_is_per_token():
    """Dropless routing: the output of a token does not depend on the
    other tokens of the call (the chunk-invariance the serving plane
    relies on), so a prefix of the batch gives the same rows."""
    _, tcfg = _configs()
    tp = build_model(tcfg).init(torch.Generator().manual_seed(1), "cpu")
    layer0 = ttr.layer_params(tp["blocks"], 0)["moe"]
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 10, 32)
                         .astype(np.float32))
    full = tmoe.moe_apply(layer0, x, tcfg)
    part = tmoe.moe_apply(layer0, x[:, :4], tcfg)
    torch.testing.assert_close(part, full[:, :4], atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ model steps
@pytest.mark.parametrize("name", ["tiny", "reduced"])
def test_schema_matches_jax_leaf_for_leaf(name):
    over = TINY if name == "tiny" else {}
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(**over)
    tcfg = reduced(get_config(ARCH)).replace(**over)
    jflat = jax.tree_util.tree_flatten_with_path(
        jtr.lm_schema(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    jleaves = {"/".join(str(k.key) for k in path):
               (tuple(p.shape), p.init, p.scale) for path, p in jflat}
    tleaves = {path: (tuple(p.shape), p.init, p.scale)
               for path, p in schema_leaves(ttr.lm_schema(tcfg))}
    assert tleaves == jleaves
    assert "blocks/moe/wd" in tleaves and "head" not in tleaves   # tied


def test_chunk_then_decode_matches_jax():
    """One chunk step and one decode step of tiny dropless granite: logits
    and both arenas (trash page P-1 excluded) within 1e-4 of JAX."""
    jcfg, tcfg = _configs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    tparams = _bridge(jparams)

    rng = np.random.RandomState(11)
    B, bt, nb, C = 3, 8, 5, 8
    L, K, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    P = B * nb + 1
    kp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    vp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    perm = rng.permutation(P - 1).astype(np.int32)
    btab = perm[:B * nb].reshape(B, nb).copy()
    btab[0, 3:] = -1                 # slot 0: 24 tokens of table
    btab[2] = -1                     # slot 2: masked (not prefilling)
    ctx = np.array([13, 9, 0], np.int32)
    valid = np.array([8, 5, 0], np.int32)   # slot 1's chunk is ragged
    toks = rng.randint(1, jcfg.vocab - 1, size=(B, C)).astype(np.int32)

    jl, jpages = jax_chunk(
        jparams, jcfg, {"kp": jnp.asarray(kp0), "vp": jnp.asarray(vp0)},
        jnp.asarray(toks), jnp.asarray(btab), jnp.asarray(ctx),
        jnp.asarray(valid))
    tpages = {"kp": _t(kp0).clone(), "vp": _t(vp0).clone()}
    tl, tpages2 = ttr.lm_paged_prefill_chunk(
        tparams, tcfg, tpages, _t(toks), _t(btab), _t(ctx), _t(valid))
    assert tpages2["kp"] is tpages["kp"], "arena must update in place"
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tpages[k].numpy()[:, :P - 1],
                                   np.asarray(jpages[k])[:, :P - 1],
                                   **STEP_TOL)

    lens = np.array([21, 14, 0], np.int32)
    dtab = btab[:, :4].copy()
    last = rng.randint(1, jcfg.vocab - 1, size=(B, 1)).astype(np.int32)
    jl2, jpages2 = jax_decode(
        jparams, jcfg, jpages, jnp.asarray(last), jnp.asarray(dtab),
        jnp.asarray(lens))
    tl2, _ = ttr.lm_paged_decode_step(
        tparams, tcfg, tpages, _t(last), _t(dtab), _t(lens))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **STEP_TOL)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tpages[k].numpy()[:, :P - 1],
                                   np.asarray(jpages2[k])[:, :P - 1],
                                   **STEP_TOL)


def test_chunked_prefill_refuses_capacity_routing():
    _, tcfg = _configs("capacity")
    tp = build_model(_configs()[1]).init(torch.Generator().manual_seed(0),
                                         "cpu")
    pages = ttr.lm_init_paged_cache(tcfg, 1, 16, 8, device="cpu")
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="dropless"):
        ttr.lm_paged_prefill_chunk(tp, tcfg, pages, z, z[:, :2],
                                   z[:, 0], z[:, 0])


# ------------------------------------------------------------ engine
def _trace(vocab=128):
    """The ragged lengths of tests/test_differential.py's _trace."""
    rng = np.random.RandomState(4321)
    lens_new = [(4, 4), (9, 1), (16, 3), (1, 5), (27, 4), (5, 2), (13, 3)]
    return [(rng.randint(1, vocab - 1, size=n).tolist(), m)
            for n, m in lens_new]


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = _configs()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    return jmodel, jparams, build_model(tcfg), _bridge(jparams)


@pytest.mark.parametrize("plane", ["paged-chunked", "paged-chunk4"])
def test_engine_wire_outputs_match_jax(engines, plane):
    jmodel, jparams, tmodel, tparams = engines
    kw = {} if plane == "paged-chunked" else dict(prefill_chunk=4)
    trace = _trace(jmodel.cfg.vocab)
    bufs = [encode_request(i, p, m) for i, (p, m) in enumerate(trace)]
    jsrv = JaxBatchServer(jmodel, batch_slots=3, max_len=MAX_LEN,
                          params=jparams, nic_cost=None, **kw)
    tsrv = BatchServer(tmodel, batch_slots=3, max_len=MAX_LEN,
                       params=tparams, device="cpu", nic_cost=None, **kw)
    for buf in bufs:
        jsrv.submit_wire(buf)
        tsrv.submit_wire(buf)
    jout = jsrv.run_until_drained()
    tout = tsrv.run_until_drained()
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert sorted(tout) == sorted(jout)          # byte-identical responses
    assert len(tout) == len(trace) and tsrv.stats["failed"] == 0
    assert tsrv.kv_stats()["paged"]["pages_in_use"] == 0, "leaked pages"
    assert tsrv.stats["prefill_chunks"] == jsrv.stats["prefill_chunks"]
    assert tsrv.stats["decode_steps"] == jsrv.stats["decode_steps"]


def test_engine_capacity_routing_raises_as_jax():
    """Capacity routing with a chunk: JAX's ValueError (under auto it
    serves one-shot: ``tests/test_torch_oneshot.py``)."""
    jcfg, tcfg = _configs("capacity")
    tmodel = build_model(tcfg)
    with pytest.raises(ValueError, match="chunk-invariant") as tex:
        BatchServer(tmodel, batch_slots=2, max_len=MAX_LEN, device="cpu",
                    nic_cost=None, prefill_chunk=8)
    with pytest.raises(ValueError, match="chunk-invariant") as jex:
        JaxBatchServer(jax_build_model(jcfg), batch_slots=2,
                       max_len=MAX_LEN, nic_cost=None, prefill_chunk=8)
    assert str(tex.value) == str(jex.value)


def test_launcher_serves_granite_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--prompt-len", "9", "--max-new", "3",
                      "--prefill-chunk", "8"])
    assert len(out) == 3
    assert "3/3 completed" in capsys.readouterr().out


@pytest.mark.parametrize("argv,words", [
    (["--moe-routing", "dropless"], "only applies to moe-family"),
], ids=["dense-arch"])
def test_launcher_moe_routing_errors(argv, words, capsys):
    with pytest.raises(SystemExit) as ex:
        serve.main(["--device", "cpu", *argv])
    assert ex.value.code == 2
    err = capsys.readouterr().err
    assert "--moe-routing" in err and words in err


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# granite's gate and down projection at decode and at a full chunk, and a
# D tail and an F tail inside an expert (the TMA kernel's 3-D maps)
GMM_MAIN_PATH = [(40, 8, 1536, 512), (40, 512, 1536, 512),
                 (40, 8, 512, 1536), (40, 512, 512, 1536),
                 (4, 64, 520, 512), (4, 64, 512, 520)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES + GMM_MAIN_PATH)
def test_moe_gmm_kernel_matches_plain_on_card(cuda, E, C, D, F, dtype, tol):
    rng = np.random.RandomState(C)
    xe = _t(rng.randn(E, C, D).astype(np.float32)).to(cuda, dtype)
    w = _t((rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32)) \
        .to(cuda, dtype)
    tma = dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0
    before = dict(ops.LAUNCHES)
    got = ops.moe_gmm(xe, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_gmm"] == before["moe_gmm"] + 1
    assert ops.LAUNCHES["moe_gmm_wgmma"] == before["moe_gmm_wgmma"] + tma
    torch.testing.assert_close(got.float(), ref.moe_gmm(xe, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["dups", "central", "pad-row", "large-n",
                                  "out-of-range", "decode", "max-tick",
                                  "odd-d", "large-n-small-m"])
def test_rao_kernel_matches_plain_on_card(cuda, case, dtype, tol):
    """Random duplicates (N 65, D 96, M 2048); CENTRAL (every update on row
    0); the pad row (80% of the ids on the last row, as dropless routing
    pads); N 5000 (the on-chip kernel's rows in several tiles); ids
    outside [0, N) (dropped: held against the plain version of the ids in
    range); granite's decode (9, 320) and largest tick (513, 20480) at D
    1536; D 130 (a column a lane); N 5000 with M 1000 (row tiles with
    CTAs of 256 threads; the others with M >= 2048 take 512).  bf16
    takes the on-chip kernel, f32 the atomic one.  After the
    first two cases the table and vals are multiples of 1/4 in [-2, 2],
    exact in bf16, whose f32 sums are exact in any order, so a hot row's
    thousands of adds are held to the tolerance whatever order the
    atomics land in."""
    rng = np.random.RandomState(9)
    N, D, M = {"large-n": (5000, 96, 3000), "decode": (9, 1536, 320),
               "max-tick": (513, 1536, 20480), "odd-d": (65, 130, 3000),
               "large-n-small-m": (5000, 96, 1000)}.get(case, (65, 96, 2048))
    idx = rng.randint(0, N, size=M).astype(np.int32)
    if case == "central":
        idx[:] = 0
    elif case in ("pad-row", "max-tick"):
        idx[rng.rand(M) < 0.8] = N - 1
    elif case == "out-of-range":
        idx[::3] = rng.choice([-1, -7, N, N + 5], size=idx[::3].shape)
    keep = (idx >= 0) & (idx < N)
    if case in ("dups", "central"):
        table, vals = rng.randn(N, D), rng.randn(M, D)
    else:
        table, vals = (rng.randint(-8, 9, size=(n, D)) / 4 for n in (N, M))
    table, vals = (_t(a.astype(np.float32)).to(cuda, dtype)
                   for a in (table, vals))
    idx_d = _t(idx).to(cuda)
    exp = ref.rao_scatter_add(table, _t(idx[keep]).to(cuda),
                              vals[torch.from_numpy(keep).to(cuda)])
    before = dict(ops.LAUNCHES)
    got = ops.rao_scatter_add(table, idx_d, vals)
    torch.cuda.synchronize()
    assert got is table
    assert ops.LAUNCHES["rao_scatter_add"] == before["rao_scatter_add"] + 1
    assert ops.LAUNCHES["rao_scatter_add_onchip"] == \
        before["rao_scatter_add_onchip"] + (dtype == torch.bfloat16)
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)
