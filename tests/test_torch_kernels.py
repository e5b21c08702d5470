"""The port's paged attention kernels against the JAX reference.

On the CPU the port's wrappers run the plain PyTorch versions
(``repro_torch.kernels.ref``); they must match the JAX Pallas kernels in
interpret mode and the jnp oracles to 1e-5 at f32, the tolerance of
``tests/test_paged_attention.py``.  The hand-written CUDA kernels are
held against the plain versions on the card (skipped without one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_prefill_attention import (
    paged_prefill_attention as jax_prefill,
)
from repro_torch.kernels import ops, ref

jax_paged = jax.jit(jax_paged, static_argnames=("window", "interpret"))
jax_prefill = jax.jit(jax_prefill, static_argnames=("window", "interpret"))
oracle_paged = jax.jit(jref.paged_attention, static_argnames=("window",))
oracle_prefill = jax.jit(jref.paged_prefill_attention,
                         static_argnames=("window",))
TOL = dict(atol=1e-5, rtol=1e-5)


def _table(rng, B, nb, bt, lens, *, neg_inside=(), stale_outside=False):
    """Shuffled block table covering ``lens`` tokens per slot in position
    order.  Entries past a slot's live blocks are -1, or, with
    ``stale_outside``, real pages that the slot must never read;
    ``neg_inside`` lists (slot, block) entries set to -1 inside the live
    range."""
    P = B * nb + 1
    perm = rng.permutation(P - 1)
    btab = np.full((B, nb), -1, np.int32)
    j = 0
    for b, L in enumerate(lens):
        for i in range(-(-int(L) // bt) if L else 0):
            btab[b, i] = perm[j]
            j += 1
    if stale_outside:
        spare = rng.randint(0, P - 1, size=(B, nb)).astype(np.int32)
        btab = np.where(btab < 0, spare, btab)
    for b, i in neg_inside:
        btab[b, i] = -1
    return P, btab


def _arrays(rng, shapes):
    return [rng.randn(*s).astype(np.float32) for s in shapes]


# name -> (B, H, K, hd, bt, nb, lens, window, neg_inside, stale_outside);
# the cases share two shape families so the jitted interpret-mode Pallas
# kernels compile once per (family, window)
DECODE_CASES = {
    # ragged lengths incl. 0, exact block boundaries and a full table
    "ragged-g1": (3, 2, 2, 16, 8, 4, [0, 16, 29], 0, (), False),
    "ragged-g4": (3, 8, 2, 16, 8, 4, [8, 21, 32], 0, (), False),
    "window-g4": (3, 8, 2, 16, 8, 4, [0, 21, 32], 12, (), False),
    "window-g1": (3, 2, 2, 16, 8, 4, [31, 16, 5], 12, (), False),
    # decode clamps -1 entries inside the live range to page 0 (not masked)
    "neg-inside-g4": (3, 8, 2, 16, 8, 4, [5, 24, 30], 0,
                      ((1, 1), (2, 0)), False),
    "neg-inside-window-g1": (3, 2, 2, 16, 8, 4, [30, 9, 25], 12,
                             ((0, 3), (2, 1)), False),
    # table columns past the live range hold real (stale) pages
    "stale-outside-g4": (3, 8, 2, 16, 8, 4, [1, 16, 0], 0, (), True),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_plain_paged_attention_matches_jax(name):
    B, H, K, hd, bt, nb, lens, window, neg, stale = DECODE_CASES[name]
    rng = np.random.RandomState(sorted(DECODE_CASES).index(name))
    P, btab = _table(rng, B, nb, bt, lens, neg_inside=neg,
                     stale_outside=stale)
    q, kp, vp, kn, vn = _arrays(rng, [(B, H, hd), (P, bt, K, hd),
                                      (P, bt, K, hd), (B, K, hd),
                                      (B, K, hd)])
    lens = np.asarray(lens, np.int32)
    before = dict(ops.LAUNCHES)
    got = ops.paged_attention(
        *map(torch.from_numpy, (q, kp, vp, btab, lens, kn, vn)),
        window=window).numpy()
    assert ops.LAUNCHES == before, "the CPU path launched a kernel"
    jx = [jnp.asarray(a) for a in (q, kp, vp, btab, lens, kn, vn)]
    kernel = np.asarray(jax_paged(*jx, window=window, interpret=True))
    oracle = np.asarray(oracle_paged(*jx, window=window))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    assert np.isfinite(got).all()


# name -> (B, C, H, K, hd, bt, nb, ctx, window, neg_inside, stale_outside)
PREFILL_CASES = {
    "c1-ragged-g1": (3, 1, 2, 2, 16, 8, 4, [0, 8, 13], 0, (), False),
    "c8-ragged-g4": (3, 8, 8, 2, 16, 8, 4, [0, 8, 24], 0, (), False),
    "c16-window-g4": (3, 16, 8, 2, 16, 8, 4, [0, 9, 16], 12, (), False),
    "c8-window-lt-chunk-g1": (3, 8, 2, 2, 16, 8, 4, [3, 16, 20], 5, (),
                              False),
    # prefill MASKS -1 entries (window-released leading blocks, holes)
    "c8-neg-inside-g4": (3, 8, 8, 2, 16, 8, 4, [24, 17, 20], 0,
                         ((0, 0), (0, 1), (2, 2)), False),
    "c16-neg-inside-window-g4": (3, 16, 8, 2, 16, 8, 4, [16, 9, 13], 12,
                                 ((0, 0), (2, 1)), False),
    "c16-stale-outside-g4": (3, 16, 8, 2, 16, 8, 4, [1, 16, 10], 0, (),
                             True),
}


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_plain_paged_prefill_attention_matches_jax(name):
    B, C, H, K, hd, bt, nb, ctx, window, neg, stale = PREFILL_CASES[name]
    rng = np.random.RandomState(100 + sorted(PREFILL_CASES).index(name))
    P, btab = _table(rng, B, nb, bt, [c + C for c in ctx], neg_inside=neg,
                     stale_outside=stale)
    q, kp, vp, kn, vn = _arrays(rng, [(B, C, H, hd), (P, bt, K, hd),
                                      (P, bt, K, hd), (B, C, K, hd),
                                      (B, C, K, hd)])
    ctx = np.asarray(ctx, np.int32)
    before = dict(ops.LAUNCHES)
    got = ops.paged_prefill_attention(
        *map(torch.from_numpy, (q, kp, vp, btab, ctx, kn, vn)),
        window=window).numpy()
    assert ops.LAUNCHES == before, "the CPU path launched a kernel"
    jx = [jnp.asarray(a) for a in (q, kp, vp, btab, ctx, kn, vn)]
    kernel = np.asarray(jax_prefill(*jx, window=window, interpret=True))
    oracle = np.asarray(oracle_prefill(*jx, window=window))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("which", ["paged_attention",
                                   "paged_prefill_attention"])
def test_wrapper_refuses_devices_without_a_kernel(which):
    """A tensor that is neither on the CPU nor on a card gets no plain
    fallback: the wrapper raises."""
    B, H, K, hd, bt, P, nb = 2, 4, 2, 16, 8, 5, 2
    meta = dict(device="meta")
    lead = (B,) if which == "paged_attention" else (B, 4)
    args = (torch.empty(*lead, H, hd, **meta),
            torch.empty(P, bt, K, hd, **meta),
            torch.empty(P, bt, K, hd, **meta),
            torch.empty(B, nb, dtype=torch.int32, **meta),
            torch.empty(B, dtype=torch.int32, **meta),
            torch.empty(*lead, K, hd, **meta),
            torch.empty(*lead, K, hd, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        getattr(ops, which)(*args)


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
@pytest.mark.parametrize("name", ["window-g4", "neg-inside-g4",
                                  "stale-outside-g4"])
def test_decode_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    B, H, K, hd, bt, nb, lens, window, neg, stale = DECODE_CASES[name]
    rng = np.random.RandomState(7)
    P, btab = _table(rng, B, nb, bt, lens, neg_inside=neg,
                     stale_outside=stale)
    arrs = _arrays(rng, [(B, H, hd), (P, bt, K, hd), (P, bt, K, hd),
                         (B, K, hd), (B, K, hd)])
    q, kp, vp, kn, vn = (torch.from_numpy(a).to(cuda, dtype) for a in arrs)
    bt_d = torch.from_numpy(btab).to(cuda)
    ln_d = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["paged_attention"]
    got = ops.paged_attention(q, kp, vp, bt_d, ln_d, kn, vn, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == before + 1
    exp = ref.paged_attention(q, kp, vp, bt_d, ln_d, kn, vn, window=window)
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["c16-window-g4", "c8-neg-inside-g4",
                                  "c16-stale-outside-g4"])
def test_prefill_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    B, C, H, K, hd, bt, nb, ctx, window, neg, stale = PREFILL_CASES[name]
    rng = np.random.RandomState(8)
    P, btab = _table(rng, B, nb, bt, [c + C for c in ctx], neg_inside=neg,
                     stale_outside=stale)
    arrs = _arrays(rng, [(B, C, H, hd), (P, bt, K, hd), (P, bt, K, hd),
                         (B, C, K, hd), (B, C, K, hd)])
    q, kp, vp, kn, vn = (torch.from_numpy(a).to(cuda, dtype) for a in arrs)
    bt_d = torch.from_numpy(btab).to(cuda)
    cx_d = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["paged_prefill_attention"]
    got = ops.paged_prefill_attention(q, kp, vp, bt_d, cx_d, kn, vn,
                                      window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_prefill_attention"] == before + 1
    exp = ref.paged_prefill_attention(q, kp, vp, bt_d, cx_d, kn, vn,
                                      window=window)
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)
