"""The port's paged model steps against the JAX model on the same params.

The JAX model's ``init(PRNGKey(k))`` params go through numpy into the
port (``repro_torch.models.convert``); one ``paged_prefill_chunk`` and
then one ``paged_decode_step`` on both sides must agree in logits and in
both arenas to 1e-4 at f32 — looser than the kernels' 1e-5 because the
matmuls sum in torch's order, not XLA's.  The trash page (index P-1)
soaks up pad and masked-slot writes with duplicate indices, whose
winner neither framework defines, so it is left out of the arena
comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtr
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import schema_leaves
from repro_torch.models.model import build_model

F32 = dict(param_dtype="float32", cache_dtype="float32")
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128)
CONFIGS = {"tiny": TINY, "reduced": {}}     # reduced: 4 layers, GQA 4/2
TOL = dict(atol=1e-4, rtol=1e-4)
# one compiled graph per step (the config is a static, hashable dataclass)
jax_chunk = jax.jit(jtr.lm_paged_prefill_chunk, static_argnums=(1,))
jax_decode = jax.jit(jtr.lm_paged_decode_step, static_argnums=(1,))


def _configs(name):
    over = dict(CONFIGS[name], **F32)
    jcfg = jax_reduced(jax_get_config("mistral-nemo-12b")).replace(**over)
    tcfg = reduced(get_config("mistral-nemo-12b")).replace(**over)
    return jcfg, tcfg


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chunk_then_decode_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    tparams = params_from_numpy(_to_numpy(jparams), "cpu", torch.float32)

    rng = np.random.RandomState(11)
    B, bt, nb, C = 3, 8, 5, 8
    L, K, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    P = B * nb + 1
    # arena with earlier context already resident (random KV)
    kp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    vp0 = rng.randn(L, P, bt, K, hd).astype(np.float32)
    perm = rng.permutation(P - 1).astype(np.int32)
    btab = perm[:B * nb].reshape(B, nb).copy()
    btab[0, 3:] = -1                 # slot 0: 24 tokens of table
    btab[2] = -1                     # slot 2: masked (not prefilling)
    ctx = np.array([13, 9, 0], np.int32)
    valid = np.array([8, 5, 0], np.int32)   # slot 1's chunk is ragged
    toks = rng.randint(1, jcfg.vocab - 1, size=(B, C)).astype(np.int32)

    # ---- one chunk step
    jl, jpages = jax_chunk(
        jparams, jcfg, {"kp": jnp.asarray(kp0), "vp": jnp.asarray(vp0)},
        jnp.asarray(toks), jnp.asarray(btab), jnp.asarray(ctx),
        jnp.asarray(valid))
    tpages = {"kp": _t(kp0).clone(), "vp": _t(vp0).clone()}
    tl, tpages2 = ttr.lm_paged_prefill_chunk(
        tparams, tcfg, tpages, _t(toks), _t(btab), _t(ctx), _t(valid))
    assert tpages2["kp"] is tpages["kp"], "arena must update in place"
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tpages[k].numpy()[:, :P - 1],
                                   np.asarray(jpages[k])[:, :P - 1], **TOL)

    # ---- one decode step on top: slot 2 stays masked
    lens = np.array([21, 14, 0], np.int32)
    dtab = btab[:, :4].copy()
    last = rng.randint(1, jcfg.vocab - 1, size=(B, 1)).astype(np.int32)
    jl2, jpages2 = jax_decode(
        jparams, jcfg, jpages, jnp.asarray(last), jnp.asarray(dtab),
        jnp.asarray(lens))
    tl2, _ = ttr.lm_paged_decode_step(
        tparams, tcfg, tpages, _t(last), _t(dtab), _t(lens))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tpages[k].numpy()[:, :P - 1],
                                   np.asarray(jpages2[k])[:, :P - 1], **TOL)
    assert np.isfinite(tl2.numpy()).all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schema_matches_jax_leaf_for_leaf(name):
    """Same leaf names, shapes and init kinds as the JAX schema: the weight
    bridge is a per-leaf copy."""
    jcfg, tcfg = _configs(name)
    jflat = jax.tree_util.tree_flatten_with_path(
        jtr.lm_schema(jcfg),
        is_leaf=lambda x: hasattr(x, "axes"))[0]
    jleaves = {"/".join(str(k.key) for k in path):
               (tuple(p.shape), p.init, p.scale) for path, p in jflat}
    tleaves = {path: (tuple(p.shape), p.init, p.scale)
               for path, p in schema_leaves(ttr.lm_schema(tcfg))}
    assert tleaves == jleaves


def test_init_on_cpu_is_seeded_and_bf16():
    tcfg = reduced(get_config("mistral-nemo-12b")).replace(**TINY)
    model = build_model(tcfg)
    a = model.init(torch.Generator().manual_seed(5), "cpu")
    b = model.init(torch.Generator().manual_seed(5), "cpu")
    assert a["blocks"]["mlp"]["wg"].dtype == torch.bfloat16
    assert a["blocks"]["mlp"]["wg"].shape == (2, 32, 64)
    assert torch.equal(a["emb"], b["emb"])
    assert not a["blocks"]["ln1"].any()          # norm scales start at 0
    std = a["blocks"]["attn"]["wq"].float().std().item()
    assert abs(std - 1 / np.sqrt(32)) < 0.05


def test_other_families_name_their_slice():
    tcfg = reduced(get_config("mistral-nemo-12b")).replace(family="audio")
    with pytest.raises(NotImplementedError, match="whisper"):
        build_model(tcfg)
