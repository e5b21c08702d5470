"""The port's VLM slice (qwen2-vl: M-RoPE, q/k/v biases, image rows)
against the JAX reference.

Inputs come from fixed numpy seeds; params from JAX's ``Model.init`` with
every zero-initialised leaf (the norm gains and the q/k/v biases) given
random values, so the biases are exercised, then bridged leaf by leaf.
At f32: ``apply_m_rope`` within 1e-5 of JAX's with distinct t/h/w
positions, and bit for bit ``apply_rope`` when the three positions are
equal; ``lm_prefill`` with image rows (``vis_embeds``) and (t, h, w)
positions (``pos_ids``), and without them, within 1e-4 at the logits and
the KV rows, the tolerance of the dense prefill in
``tests/test_torch_oneshot.py``; a paged chunk then a paged decode step,
and the dense-cache prefill and three decode steps, within 1e-4.  The
engines' greedy tokens, scheduler counts and whole ``kv_stats()`` equal
JAX's on the chunked and one-shot paged planes and the bucketed
dense-cache plane, which serve the family as text, as JAX's do.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import rpc as jwire
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.model import build_model as jax_build_model
from repro.runtime.server import BatchServer as JaxBatchServer
from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import schema_leaves
from repro_torch.models.model import build_model
from repro_torch.runtime.server import BatchServer, encode_request

ARCH = "qwen2-vl-7b"
F32 = dict(param_dtype="float32", cache_dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)
ROPE_TOL = dict(atol=1e-5, rtol=1e-5)
jax_prefill = jax.jit(lambda p, cfg, b, n: jtr.lm_prefill(p, cfg, b,
                                                          max_len=n),
                      static_argnums=(1, 3))
jax_chunk = jax.jit(jtr.lm_paged_prefill_chunk, static_argnums=(1,))
jax_decode = jax.jit(jtr.lm_paged_decode_step, static_argnums=(1,))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX cfg, port cfg, JAX params, bridged params): reduced qwen2-vl
    (4 layers, d_model 64, 4/2 heads of 16, sections (2, 3, 3)) at f32,
    every zero-initialised leaf randomised."""
    over = dict(F32)
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(**over)
    tcfg = reduced(get_config(ARCH)).replace(**over)
    rng = np.random.RandomState(17)
    jparams = jax.tree.map(np.asarray,
                           jax_build_model(jcfg).init(jax.random.PRNGKey(3)))

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.randn(*v.shape).astype(np.float32) * 0.1
                 if not v.any() else v)
                for k, v in tree.items()}
    jparams = fill(jparams)
    assert jparams["blocks"]["attn"]["bq"].any()
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jparams), \
        params_from_numpy(jparams, "cpu", torch.float32)


def _grid_pos(B, S, P, grid_w):
    """qwen2-vl positions: P image rows on a (P / grid_w) x grid_w grid at
    t 0 (h, w over the patches), the text continuing from the largest
    image position plus one on all three sections."""
    pos = np.zeros((B, S, 3), np.int32)
    i = np.arange(P)
    pos[:, :P, 1] = i // grid_w
    pos[:, :P, 2] = i % grid_w
    start = max(P // grid_w, grid_w)
    pos[:, P:, :] = (start + np.arange(S - P))[None, :, None]
    return pos


# ------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24),
                                                          128)])
def test_m_rope_matches_jax_and_rope_at_equal_positions(sections, hd):
    rng = np.random.RandomState(hd)
    x = rng.randn(2, 11, 3, hd).astype(np.float32)
    pos3 = rng.randint(0, 700, size=(2, 11, 3)).astype(np.int32)
    assert len(set(pos3[0, 0])) == 3                  # t, h, w distinct
    got = tlayers.apply_m_rope(_t(x), _t(pos3), sections, 1e6)
    exp = jlayers.apply_m_rope(jnp.asarray(x), jnp.asarray(pos3), sections,
                               1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **ROPE_TOL)
    # equal sections: RoPE's angles, bit for bit
    flat = rng.randint(0, 700, size=(2, 11)).astype(np.int32)
    same = np.repeat(flat[..., None], 3, axis=-1)
    m = tlayers.apply_m_rope(_t(x), _t(same), sections, 1e6)
    r = tlayers.apply_rope(_t(x), _t(flat), 1e6)
    assert torch.equal(m, r)


def test_schema_matches_jax_with_biases():
    jcfg, tcfg, _, _ = pair()
    jflat = jax.tree_util.tree_flatten_with_path(
        jtr.lm_schema(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    jleaves = {"/".join(str(k.key) for k in path):
               (tuple(p.shape), p.init, p.scale) for path, p in jflat}
    tleaves = {path: (tuple(p.shape), p.init, p.scale)
               for path, p in schema_leaves(ttr.lm_schema(tcfg))}
    assert tleaves == jleaves
    assert "blocks/attn/bq" in tleaves and "blocks/attn/bv" in tleaves


# ------------------------------------------------------------ prefill
@pytest.mark.parametrize("inputs", ["text", "pos_ids", "image"])
def test_lm_prefill_matches_jax(inputs):
    """Text only (RoPE, as JAX without ``pos_ids``), text with (t, h, w)
    positions, and image rows with the grid's positions."""
    jcfg, tcfg, jparams, tparams = pair()
    B, S, P = 2, 21, jcfg.n_patch_tokens
    rng = np.random.RandomState(5)
    toks = rng.randint(1, jcfg.vocab - 1, size=(B, S)).astype(np.int32)
    batch, kw = {"tokens": jnp.asarray(toks)}, {}
    if inputs != "text":
        pos = _grid_pos(B, S, P, 4)
        batch["pos_ids"] = jnp.asarray(pos)
        kw["pos_ids"] = _t(pos)
    if inputs == "image":
        vis = rng.randn(B, P, jcfg.d_model).astype(np.float32)
        batch["vis_embeds"] = jnp.asarray(vis)
        kw["vis_embeds"] = _t(vis)
    jl, jc = jax_prefill(jparams, jcfg, batch, None)
    tl, tc = build_model(tcfg).prefill(tparams, _t(toks), **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        assert tc[k].shape == jc[k].shape == (4, B, S, 2, 16)
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    assert int(tc["cur"]) == int(jc["cur"]) == S


def test_image_rows_at_text_positions_equal_the_text_prefill():
    """Image rows that are the prompt's own embedding rows, at positions
    broadcast over the sections, give the text-only prefill bit for bit;
    a grid's positions give other logits."""
    _, tcfg, _, tparams = pair()
    model = build_model(tcfg)
    B, S, P = 2, 21, tcfg.n_patch_tokens
    toks = _t(np.random.RandomState(8).randint(1, 500, size=(B, S))
              .astype(np.int32))
    text, _ = model.prefill(tparams, toks)
    vis = tparams["emb"][toks[:, :P].long()]
    flat = torch.arange(S)[None, :, None].expand(B, S, 3)
    same, _ = model.prefill(tparams, toks, vis_embeds=vis, pos_ids=flat)
    assert torch.equal(same, text)
    grid, _ = model.prefill(tparams, toks, vis_embeds=vis,
                            pos_ids=_t(_grid_pos(B, S, P, 4)))
    assert torch.isfinite(grid).all() and not torch.equal(grid, text)


# ------------------------------------------------------------ steps
def test_chunk_then_decode_matches_jax():
    """One paged chunk (a ragged slot and a masked one) over an arena of
    random context, then one paged decode step: logits and both arenas
    (the trash page left out) within 1e-4."""
    jcfg, tcfg, jparams, tparams = pair()
    rng = np.random.RandomState(11)
    B, bt, nb, C = 3, 8, 5, 8
    L, K, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    P = B * nb + 1
    kp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    vp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    btab = rng.permutation(P - 1).astype(np.int32)[:B * nb].reshape(B, nb)
    btab[0, 3:] = -1
    btab[2] = -1
    ctx = np.array([13, 9, 0], np.int32)
    valid = np.array([8, 5, 0], np.int32)
    toks = rng.randint(1, jcfg.vocab - 1, size=(B, C)).astype(np.int32)
    jl, jpages = jax_chunk(
        jparams, jcfg, {"kp": jnp.asarray(kp0), "vp": jnp.asarray(vp0)},
        jnp.asarray(toks), jnp.asarray(btab), jnp.asarray(ctx),
        jnp.asarray(valid))
    tpages = {"kp": _t(kp0).clone(), "vp": _t(vp0).clone()}
    tl, _ = ttr.lm_paged_prefill_chunk(tparams, tcfg, tpages, _t(toks),
                                       _t(btab), _t(ctx), _t(valid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tpages[k].numpy()[:, :P - 1],
                                   np.asarray(jpages[k])[:, :P - 1], **TOL)
    lens = np.array([21, 14, 0], np.int32)
    last = rng.randint(1, jcfg.vocab - 1, size=(B, 1)).astype(np.int32)
    jl, jpages = jax_decode(jparams, jcfg, jpages, jnp.asarray(last),
                            jnp.asarray(btab[:, :4]), jnp.asarray(lens))
    tl, _ = ttr.lm_paged_decode_step(tparams, tcfg, tpages, _t(last),
                                     _t(btab[:, :4]), _t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tpages[k].numpy()[:, :P - 1],
                                   np.asarray(jpages[k])[:, :P - 1], **TOL)


def test_dense_cache_prefill_and_three_decode_steps_match_jax():
    jcfg, tcfg, jparams, tparams = pair()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    rng = np.random.RandomState(13)
    toks = rng.randint(1, jcfg.vocab - 1, size=(2, 11)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tmodel.prefill(tparams, _t(toks), 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(jmodel.decode_step)
    for _ in range(3):
        last = rng.randint(1, jcfg.vocab - 1, size=(2, 1)).astype(np.int32)
        jl, jc = jdec(jparams, jc, jnp.asarray(last))
        tl, tc = tmodel.decode_step(tparams, tc, _t(last))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **TOL)
        assert int(tc["cur"]) == int(jc["cur"])


# ------------------------------------------------------------ engine
def _trace(vocab):
    """The differential trace: ragged lengths incl. single-token and
    max-capacity prompts, max_new incl. 1."""
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


COUNTS = ("prefills", "prefill_chunks", "decode_steps", "completed",
          "failed", "admitted", "ticks", "decode_tokens")
ENGINES = {"chunked": {}, "one-shot": dict(prefill_chunk=0),
           "dense-bucketed": dict(paged_kv=False)}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_matches_jax(name):
    jcfg, tcfg, jparams, tparams = pair()
    kw = ENGINES[name]
    jsrv = JaxBatchServer(jax_build_model(jcfg), batch_slots=3, max_len=32,
                          params=jparams, nic_cost=None, **kw)
    tsrv = BatchServer(build_model(tcfg), batch_slots=3, max_len=32,
                       params=tparams, device="cpu", nic_cost=None, **kw)
    assert tsrv.paged == jsrv.paged == (name != "dense-bucketed")
    assert tsrv.prefill_chunk == jsrv.prefill_chunk
    assert tsrv.dense_buckets == jsrv.dense_buckets
    trace = _trace(jcfg.vocab)
    for i, (p, m) in enumerate(trace):
        jsrv.submit_wire(encode_request(i, p, m))
        tsrv.submit_wire(encode_request(i, p, m))
    jout, tout = jsrv.run_until_drained(), tsrv.run_until_drained()
    assert _outs(tout, wire) == _outs(jout, jwire)
    assert len(tout) == len(trace)
    assert {k: tsrv.stats[k] for k in COUNTS} == \
        {k: jsrv.stats[k] for k in COUNTS}
    assert tsrv.kv_stats() == jsrv.kv_stats()


@pytest.mark.parametrize("extra", [[], ["--no-paged-kv"]],
                         ids=["paged", "dense"])
def test_launcher_serves_qwen2_vl_on_cpu(extra, capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--max-new", "3", *extra])
    assert len(out) == 3
    text = capsys.readouterr().out
    assert "3/3 completed" in text and \
        ("kv: dense cache" if extra else "kv: paged cache") in text
