"""The port's copy-on-write prefix cache against the JAX engine's:
shared-system-prompt traffic (``TestSharedPrefixDifferential`` of
``tests/test_differential.py``) through the port's ``BatchServer`` and
the JAX one on the same params, chunked and one-shot, cold and with
``prefix_cache=True``, and under a watermark that evicts on every step.

Rows: tiny mistral-nemo, tiny granite-moe with dropless routing (the MoE
config the port serves, in place of JAX's qwen3 row) and tiny
h2o-danube (window 16, with window-crossing tails).  Each run's greedy
tokens equal JAX's engine's, and so do ``kv_stats()["prefix"]`` (hits,
hit tokens, evictions) and ``blocks_allocated``; the cache hits and the
hot run allocates fewer blocks than the cold one.  Ring-packed one-shot
rows (prompt longer than the window) neither acquire from the cache nor
publish into it.  All at f32, so greedy argmax equality is exact.
"""
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

# the _tiny overrides of tests/test_differential.py, at f32
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, param_dtype="float32",
            cache_dtype="float32")
BT = 8            # full shareable blocks even at the danube prefix (8)
PREFIX_KEYS = ("hits", "hit_tokens", "evicted", "published", "entries")


def _row(fam):
    """(arch, over, key, prefix_len, tails, max_len) of each row."""
    if fam == "dense":
        return "mistral-nemo-12b", {}, 3, 16, (1, 5, 9, 12, 3, 7, 11), 32
    if fam == "moe":
        return "granite-moe-3b-a800m", dict(moe_routing="dropless"), 2, \
            16, (1, 5, 9, 12, 3, 7), 32
    W = 16
    return "h2o-danube-3-4b", {}, 5, 8, (1, 5, W, 3, W + 6, 7), 2 * W + 16


def _outs(bufs, codec):
    out = {}
    for buf in bufs:
        msg = codec.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


def _drained(srv):
    """Post-drain leak check: retained prefix pages are deliberate, so
    force-flush them first, then nothing may remain."""
    if srv.prefix_cache:
        srv.pager.evict_prefixes()
    return srv.kv_stats()["paged"]["pages_in_use"] == 0


class TestSharedPrefix:

    @pytest.fixture(scope="class", params=["dense", "moe", "swa"])
    def setup(self, request):
        arch, over, key, prefix_len, tails, max_len = _row(request.param)
        jcfg = jax_reduced(jax_get_config(arch)).replace(**TINY, **over)
        tcfg = reduced(get_config(arch)).replace(**TINY, **over)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(key))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    "cpu", torch.float32)
        rng = np.random.RandomState(4321 + key)
        prefix = rng.randint(1, jcfg.vocab - 1, size=prefix_len).tolist()
        trace = [(prefix + rng.randint(1, jcfg.vocab - 1,
                                       size=t).tolist(), 3) for t in tails]
        return (jmodel, jparams, build_model(tcfg), tparams, trace,
                max_len)

    @staticmethod
    def _pair(setup, slots=3, **kw):
        """The same trace through the JAX engine and the port's; the
        port's tokens, scheduler counts and KV accounting equal JAX's.
        Returns the port's outputs and ``kv_stats()`` after the drain."""
        jmodel, jparams, tmodel, tparams, trace, max_len = setup
        common = dict(batch_slots=slots, max_len=max_len, nic_cost=None,
                      block_tokens=BT, **kw)
        jsrv = JaxBatchServer(jmodel, params=jparams, **common)
        tsrv = BatchServer(tmodel, params=tparams, device="cpu", **common)
        for i, (p, m) in enumerate(trace):
            buf = encode_request(i, p, m)
            jsrv.submit_wire(buf)
            tsrv.submit_wire(buf)
        jout = jsrv.run_until_drained()
        tout = tsrv.run_until_drained()
        assert _outs(tout, wire) == _outs(jout, jwire)
        assert sorted(tout) == sorted(jout)      # byte-identical responses
        assert len(tout) == len(trace) and tsrv.stats["failed"] == 0
        for key in ("prefills", "prefill_chunks", "decode_steps", "ticks"):
            assert tsrv.stats[key] == jsrv.stats[key], key
        tkv, jkv = tsrv.kv_stats(), jsrv.kv_stats()
        assert tkv["blocks_allocated"] == jkv["blocks_allocated"]
        assert tkv["blocks_freed"] == jkv["blocks_freed"]
        if tsrv.prefix_cache:
            for key in PREFIX_KEYS:
                assert tkv["prefix"][key] == jkv["prefix"][key], key
        assert tkv == jkv
        assert _drained(tsrv) and _drained(jsrv)
        return _outs(tout, wire), tkv

    @pytest.mark.parametrize("mode", [dict(), dict(prefill_chunk=0)],
                             ids=["chunked", "oneshot"])
    def test_cached_equals_cold_sync(self, setup, mode):
        """The hot run against JAX's; the cold run (held against JAX by
        the port's engine tests) on the port alone, for its tokens and
        its block count."""
        _, _, tmodel, tparams, trace, max_len = setup
        csrv = BatchServer(tmodel, params=tparams, device="cpu",
                           batch_slots=3, max_len=max_len, nic_cost=None,
                           block_tokens=BT, **mode)
        for i, (p, m) in enumerate(trace):
            csrv.submit_wire(encode_request(i, p, m))
        cold_out = _outs(csrv.run_until_drained(), wire)
        cold = csrv.kv_stats()
        hot_out, hot = self._pair(setup, prefix_cache=True, **mode)
        assert hot_out == cold_out, "prefix cache changed greedy tokens"
        assert hot["prefix"]["hits"] > 0
        assert hot["prefix"]["hit_tokens"] > 0
        # shared pages are mapped, not re-allocated
        assert hot["blocks_allocated"] < cold["blocks_allocated"]

    def test_forced_midflight_eviction_is_bit_identical(self, setup):
        """A watermark that flushes retained entries on every step only
        costs hits, as in JAX.  One slot serves the trace in series, so
        every row has unreferenced entries while later requests run (with
        three slots the danube row's single prefix block is never free of
        a reader when the watermark looks)."""
        _, st = self._pair(setup, slots=1, prefix_cache=True,
                           prefix_watermark=0.95)
        assert st["prefix"]["evicted"] > 0


def test_ring_packed_oneshot_rows_skip_the_cache():
    """One-shot danube: a prompt longer than the window is written ring-
    unpermuted with zeros before its last W positions, so it must neither
    map a cached prefix nor publish one; a short prompt after it still
    hits what the first short one published."""
    arch, _, key, _, _, max_len = _row("swa")
    jcfg = jax_reduced(jax_get_config(arch)).replace(**TINY)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(key))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                torch.float32)
    tmodel = build_model(reduced(get_config(arch)).replace(**TINY))
    rng = np.random.RandomState(11)
    prefix = rng.randint(1, 127, size=8).tolist()
    prompts = [prefix + rng.randint(1, 127, size=n).tolist()
               for n in (3, 20, 5)]          # 11, 28 (> W = 16), 13 tokens
    common = dict(batch_slots=1, max_len=max_len, nic_cost=None,
                  block_tokens=BT, prefix_cache=True, prefill_chunk=0)
    jsrv = JaxBatchServer(jmodel, params=jparams, **common)
    tsrv = BatchServer(tmodel, params=tparams, device="cpu", **common)
    seen = []
    for i, p in enumerate(prompts):
        for srv, codec in ((jsrv, jwire), (tsrv, wire)):
            srv.submit_wire(encode_request(i, p, 2))
        outs = [_outs(srv.run_until_drained(), codec)
                for srv, codec in ((jsrv, jwire), (tsrv, wire))]
        assert outs[0] == outs[1]
        seen.append(dict(tsrv.kv_stats()["prefix"]))
        assert seen[-1] == jsrv.kv_stats()["prefix"]
    first, ring, short = seen
    assert first["hits"] == 0 and first["published"] > 0
    # the ring-packed row: no hit, nothing published
    assert ring["hits"] == 0 and ring["published"] == first["published"]
    # the short row after it maps the first row's prefix block
    assert short["hits"] == 1 and short["hit_tokens"] == 8
    assert _drained(tsrv)


def test_launcher_serves_danube_with_the_prefix_cache(capsys):
    out = serve.main(["--arch", "h2o-danube-3-4b", "--device", "cpu",
                      "--requests", "4", "--slots", "2", "--prompt-len", "5",
                      "--shared-prefix-len", "32", "--max-new", "3",
                      "--prefix-cache", "--prefix-watermark", "0.5"])
    assert len(out) == 4
    text = capsys.readouterr().out
    assert "4/4 completed" in text and "prefix cache:" in text


@pytest.mark.parametrize("argv,words", [
    (["--prefix-watermark", "0.5"], "requires --prefix-cache"),
    (["--prefix-cache", "--prefix-watermark", "1.5"], r"in \[0, 1\)"),
], ids=["watermark-alone", "watermark-range"])
def test_launcher_validates_prefix_options_as_jax(argv, words, capsys):
    with pytest.raises(SystemExit) as ex:
        serve.main(["--device", "cpu", *argv])
    assert ex.value.code == 2
    assert words.replace("\\", "") in capsys.readouterr().err


def test_engine_validates_prefix_options_as_jax():
    tcfg = reduced(get_config("mistral-nemo-12b")).replace(**TINY)
    with pytest.raises(ValueError, match=r"prefix_watermark must be in"):
        BatchServer(build_model(tcfg), batch_slots=2, max_len=32,
                    device="cpu", nic_cost=None, prefix_cache=True,
                    prefix_watermark=1.0)
    hyb = reduced(get_config("zamba2-7b")).replace(**TINY)
    with pytest.raises(ValueError, match="requires the paged KV plane"):
        BatchServer(build_model(hyb), batch_slots=2, max_len=32,
                    device="cpu", nic_cost=None, prefix_cache=True)
