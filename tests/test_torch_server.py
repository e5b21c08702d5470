"""The port's paged engine against the JAX engine, and its launcher.

Both ``BatchServer``s serve the same ragged trace (the lengths of
``tests/test_differential.py``'s ``_trace``) at f32 on the same params;
the decoded wire outputs must be identical token for token on the four
chunked planes, with no pages left in use after the drain (the one-shot
planes are in ``tests/test_torch_oneshot.py``).  The port also
imports nothing of JAX or of the JAX package.
"""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import rpc as jwire
from repro.models.model import build_model as jax_build_model
from repro.runtime.server import BatchServer as JaxBatchServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.runtime.server import BatchServer, encode_request

REPO = pathlib.Path(__file__).resolve().parent.parent
F32 = dict(param_dtype="float32", cache_dtype="float32")
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, **F32)
MAX_LEN = 32
PLANES = {
    "paged-chunked": dict(),
    "paged-chunk4": dict(prefill_chunk=4),
    "paged-chunk8-b1": dict(prefill_chunk=8, prefill_buckets=1),
    "paged-chunk16-b4": dict(prefill_chunk=16, prefill_buckets=4),
}


def _trace(vocab=128):
    """Ragged lengths incl. single-token, block-boundary, multi-chunk and
    near-capacity prompts; max_new incl. 1 (prefill-only completion)."""
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
def setup():
    jcfg = jax_reduced(jax_get_config("mistral-nemo-12b")).replace(**TINY)
    tcfg = reduced(get_config("mistral-nemo-12b")).replace(**TINY)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tparams = params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
        "cpu", torch.float32)
    return jmodel, jparams, build_model(tcfg), tparams, _trace(jcfg.vocab)


@pytest.mark.parametrize("plane", sorted(PLANES))
def test_engine_wire_outputs_match_jax(setup, plane):
    jmodel, jparams, tmodel, tparams, trace = setup
    kw = PLANES[plane]
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


def test_engine_without_card_raises_unless_cpu_requested(setup):
    _, _, tmodel, tparams, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchServer(tmodel, batch_slots=2, max_len=MAX_LEN, nic_cost=None)


def test_pool_keeps_the_reference_hbm_tier_on_cpu(setup):
    """On the CPU the pool keeps the reference package's HBM tier, so the
    CPU engine's pool accounting matches the JAX engine's."""
    _, _, tmodel, tparams, _ = setup
    srv = BatchServer(tmodel, batch_slots=2, max_len=MAX_LEN, params=tparams,
                      device="cpu", nic_cost=None)
    assert srv.pager.pool.tiers["hbm"].stream_bw_GBs == 819.0
    assert srv.pager.pool.tiers["hbm"].capacity_bytes == 16 << 30


def test_pool_takes_the_cards_hbm_tier_on_cuda(setup):
    """On a card the pool's HBM tier is the card's capacity at the H100's
    published stream rate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, tmodel, tparams, _ = setup
    dev = torch.device("cuda")
    cuda_params = jax.tree.map(lambda t: t.to(dev), tparams)
    srv = BatchServer(tmodel, batch_slots=2, max_len=MAX_LEN,
                      params=cuda_params, device=dev, nic_cost=None)
    hbm = srv.pager.pool.tiers["hbm"]
    assert hbm.stream_bw_GBs == 3350.0
    assert hbm.capacity_bytes == torch.cuda.get_device_properties(
        dev).total_memory


def test_launcher_drains_on_cpu(capsys):
    out = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                      "--prompt-len", "9", "--max-new", "3",
                      "--prefill-chunk", "8"])
    assert len(out) == 3
    assert "3/3 completed" in capsys.readouterr().out


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{f.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
