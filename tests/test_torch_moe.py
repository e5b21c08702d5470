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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES)
def test_moe_gmm_kernel_matches_plain_on_card(cuda, E, C, D, F, dtype, tol):
    rng = np.random.RandomState(C)
    xe = _t(rng.randn(E, C, D).astype(np.float32)).to(cuda, dtype)
    w = _t((rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32)) \
        .to(cuda, dtype)
    before = ops.LAUNCHES["moe_gmm"]
    got = ops.moe_gmm(xe, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_gmm"] == before + 1
    torch.testing.assert_close(got.float(), ref.moe_gmm(xe, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("central", [False, True], ids=["dups", "central"])
def test_rao_kernel_matches_plain_on_card(cuda, central, dtype, tol):
    rng = np.random.RandomState(9)
    N, D, M = 65, 96, 2048
    idx = np.zeros(M, np.int32) if central \
        else rng.randint(0, N, size=M).astype(np.int32)
    table = _t(rng.randn(N, D).astype(np.float32)).to(cuda, dtype)
    vals = _t(rng.randn(M, D).astype(np.float32)).to(cuda, dtype)
    idx_d = _t(idx).to(cuda)
    exp = ref.rao_scatter_add(table, idx_d, vals)
    before = ops.LAUNCHES["rao_scatter_add"]
    got = ops.rao_scatter_add(table, idx_d, vals)
    torch.cuda.synchronize()
    assert got is table and ops.LAUNCHES["rao_scatter_add"] == before + 1
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)
