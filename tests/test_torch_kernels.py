"""The port's paged attention kernels against the JAX reference.

On the CPU the port's wrappers run the plain PyTorch versions
(``repro_torch.kernels.ref``); they must match the JAX Pallas kernels in
interpret mode and the jnp oracles to 1e-5 at f32, the tolerance of
``tests/test_paged_attention.py``.  The hand-written CUDA kernels are
held against the plain versions on the card (skipped without one); bf16
decode takes the split-KV cluster kernel and bf16 chunked prefill the
tensor-core kernel, both of which must keep the f32 softmax weights of
the paged contract.
"""
import math
from types import SimpleNamespace

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
from repro_torch.kernels import build, ops, ref

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


def test_paged_decode_kernel_table():
    """bf16 takes the split-KV cluster kernel, f32 the one-CTA one; both
    sources are built."""
    assert ops.PAGED_DECODE_KERNELS == {
        torch.bfloat16: "paged_attention_split_launch",
        torch.float32: "paged_attention_launch"}
    for src in ("paged_attention.cu", "paged_attention_split.cu"):
        assert src in build.SOURCES and (build.CSRC / src).is_file()
    assert "paged_attention_split" in ops.LAUNCHES


def test_build_binds_the_decode_launchers():
    """ctypes passes every pointer as c_void_p: the split-KV launcher takes
    q .. out, then B H K hd bt nb window as ints, the scale and the stream;
    the one-CTA one the same after its dtype; the geometry query H K hd bt
    nb and a pointer to four ints."""
    class Lib:
        def __getattr__(self, name):
            fn = SimpleNamespace()
            setattr(self, name, fn)
            return fn
    lib = build._bind(Lib())
    c = build.ctypes
    p, i, f = c.c_void_p, c.c_int, c.c_float
    split = [p] * 8 + [i] * 7 + [f, p]
    assert lib.paged_attention_split_launch.argtypes == split
    assert lib.paged_attention_split_launch.restype == i
    assert lib.paged_attention_launch.argtypes == [i] + split
    assert lib.paged_attention_split_geometry.argtypes == \
        [i] * 5 + [c.POINTER(i)]
    assert lib.paged_attention_split_geometry.restype == i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_cpu_call_launches_nothing(dtype):
    """On the CPU both dtypes run the plain version, whichever kernel the
    table names for the card."""
    B, H, K, hd, bt, nb, lens, window, neg, stale = \
        DECODE_CASES["neg-inside-window-g1"]
    rng = np.random.RandomState(10)
    P, btab = _table(rng, B, nb, bt, lens, neg_inside=neg)
    arrs = _arrays(rng, [(B, H, hd), (P, bt, K, hd), (P, bt, K, hd),
                         (B, K, hd), (B, K, hd)])
    q, kp, vp, kn, vn = (torch.from_numpy(a).to(dtype) for a in arrs)
    args = (q, kp, vp, torch.from_numpy(btab),
            torch.tensor(lens, dtype=torch.int32), kn, vn)
    before = dict(ops.LAUNCHES)
    got = ops.paged_attention(*args, window=window)
    assert ops.LAUNCHES == before, "the CPU path launched a kernel"
    assert got.dtype == dtype
    torch.testing.assert_close(
        got, ref.paged_attention(*args, window=window), atol=0, rtol=0)


def test_paged_prefill_kernel_table():
    """bf16 takes the tensor-core kernel, f32 the CUDA-core one; both
    sources are built."""
    assert ops.PAGED_PREFILL_KERNELS == {
        torch.bfloat16: "paged_prefill_attention_mma_launch",
        torch.float32: "paged_prefill_attention_launch"}
    for src in ("paged_prefill_attention.cu",
                "paged_prefill_attention_mma.cu"):
        assert src in build.SOURCES and (build.CSRC / src).is_file()
    assert "paged_prefill_attention_mma" in ops.LAUNCHES


def test_build_binds_the_prefill_launchers():
    """ctypes passes every pointer of the launchers as c_void_p (an int
    would cut it to 32 bits): the mma launcher takes q .. out, then B C H
    K hd bt nb window as ints, the scale and the stream; the CUDA-core one
    the same after its dtype."""
    class Lib:
        """Answers every launcher name with a fresh namespace."""
        def __getattr__(self, name):
            fn = SimpleNamespace()
            setattr(self, name, fn)
            return fn
    lib = build._bind(Lib())
    p, i, f = build.ctypes.c_void_p, build.ctypes.c_int, build.ctypes.c_float
    mma = [p] * 8 + [i] * 8 + [f, p]
    assert lib.paged_prefill_attention_mma_launch.argtypes == mma
    assert lib.paged_prefill_attention_mma_launch.restype == i
    assert lib.paged_prefill_attention_launch.argtypes == [i] + mma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_cpu_call_launches_nothing(dtype):
    """On the CPU both dtypes run the plain version, whichever kernel the
    table names for the card."""
    B, C, H, K, hd, bt, nb, ctx, window, neg, stale = \
        PREFILL_CASES["c8-neg-inside-g4"]
    rng = np.random.RandomState(9)
    P, btab = _table(rng, B, nb, bt, [c + C for c in ctx], neg_inside=neg)
    arrs = _arrays(rng, [(B, C, H, hd), (P, bt, K, hd), (P, bt, K, hd),
                         (B, C, K, hd), (B, C, K, hd)])
    q, kp, vp, kn, vn = (torch.from_numpy(a).to(dtype) for a in arrs)
    args = (q, kp, vp, torch.from_numpy(btab),
            torch.tensor(ctx, dtype=torch.int32), kn, vn)
    before = dict(ops.LAUNCHES)
    got = ops.paged_prefill_attention(*args, window=window)
    assert ops.LAUNCHES == before, "the CPU path launched a kernel"
    assert got.dtype == dtype
    torch.testing.assert_close(
        got, ref.paged_prefill_attention(*args, window=window),
        atol=0, rtol=0)


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


# the card's decode cases: name -> (B, H, K, hd, bt, nb, lens, window,
# neg_inside, stale_outside) — granite's heads, head dims 120 (padded to
# 128), 256 and 40 (padded to 48, with 17 query heads a kv head: two
# m-tiles), one, eight and 32 query heads a kv head, block sizes 24 (no
# divisor of 64) and 32, one-token blocks in a 600-entry table, a new slot (L = 0) beside -1 entries
# inside the live range, and windows
CARD_DECODE_CASES = {
    "granite-window": (4, 24, 8, 64, 16, 24, [0, 37, 217, 294], 100,
                       ((2, 1),), False),
    "hd120": (3, 32, 8, 120, 16, 24, [5, 128, 300], 0, ((1, 0),), False),
    "hd256-window": (3, 8, 2, 256, 16, 24, [64, 200, 380], 100, (), True),
    "hd40-g17": (3, 34, 2, 40, 16, 24, [1, 150, 383], 0, (), False),
    "g1": (3, 8, 8, 128, 16, 24, [0, 96, 310], 0, ((2, 0),), False),
    "g8-window": (3, 32, 4, 128, 16, 24, [17, 64, 290], 100, (), False),
    "g32": (3, 32, 1, 128, 16, 24, [3, 130, 270], 0, ((1, 2),), True),
    "bt24": (3, 32, 8, 128, 24, 16, [0, 100, 380], 0, ((2, 3),), False),
    "bt32-window": (3, 32, 8, 128, 32, 12, [31, 160, 383], 100,
                    ((1, 2),), False),
    "bt1-wide-table": (2, 32, 8, 128, 1, 600, [599, 250], 0, ((0, 7),),
                       False),
    "new-slot-neg-inside": (4, 32, 8, 128, 16, 24, [0, 16, 250, 300], 0,
                            ((1, 0), (2, 3), (3, 10)), False),
}


def _card_decode_inputs(cases, name, dtype, device, seed=12):
    B, H, K, hd, bt, nb, lens, window, neg, stale = cases[name]
    rng = np.random.RandomState(seed)
    P, btab = _table(rng, B, nb, bt, lens, neg_inside=neg,
                     stale_outside=stale)
    arrs = _arrays(rng, [(B, H, hd), (P, bt, K, hd), (P, bt, K, hd),
                         (B, K, hd), (B, K, hd)])
    q, kp, vp, kn, vn = (torch.from_numpy(a).to(device, dtype) for a in arrs)
    return (q, kp, vp, torch.from_numpy(btab).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device), kn, vn), \
        window


def _decode_on_card(args, window, dtype, tol):
    """One decode call, its launch counts (bf16 on the split-KV kernel)
    and its agreement with the plain version."""
    before = dict(ops.LAUNCHES)
    got = ops.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == before["paged_attention"] + 1
    assert ops.LAUNCHES["paged_attention_split"] == \
        before["paged_attention_split"] + (dtype == torch.bfloat16)
    exp = ref.paged_attention(*args, window=window)
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)
    return got, exp


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CARD_DECODE_CASES))
def test_decode_split_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    args, window = _card_decode_inputs(CARD_DECODE_CASES, name, dtype, cuda)
    _decode_on_card(args, window, dtype, tol)


# contexts over 8 x 64 keys: every CTA of a cluster walks several tiles
# through the two-stage ring, at G 4, hd 128 and at the largest shape, G
# 32, hd 256
LONG_DECODE_CASES = {
    "long-g4": (4, 32, 8, 128, 16, 64, [900, 1023, 0, 513], 0, ((1, 40),),
                False),
    "long-g4-window": (4, 32, 8, 128, 16, 64, [900, 1023, 0, 513], 700,
                       ((1, 40),), False),
    "long-g32-hd256": (3, 32, 1, 256, 16, 64, [1000, 0, 700], 0, ((0, 5),),
                       False),
}


@pytest.mark.parametrize("name,stages", [("long-g4", 2),
                                         ("long-g4-window", 2),
                                         ("long-g32-hd256", 2)])
def test_decode_split_walks_several_tiles_on_card(cuda, name, stages):
    B, H, K, hd, bt, nb = LONG_DECODE_CASES[name][:6]
    geo = ops.paged_attention_split_geometry(H, K, hd, bt, nb)
    assert (geo["split"], geo["stages"]) == (8, stages)
    assert geo["clusters"] > 0
    args, window = _card_decode_inputs(LONG_DECODE_CASES, name,
                                       torch.bfloat16, cuda)
    _decode_on_card(args, window, torch.bfloat16, 2e-2)


def test_decode_split_launch_never_syncs_on_card(cuda):
    """The launch is sized from the table width alone: under sync debug
    mode "error" a decode call (after a first call, which builds the
    library) must not synchronise, so the host never reads seq_lens."""
    args, window = _card_decode_inputs(CARD_DECODE_CASES, "g8-window",
                                       torch.bfloat16, cuda)
    ops.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.paged_attention(*args, window=window)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())


def _decode_bf16_weights(q, kp, vp, btab, lens, kn, vn):
    """``ref.paged_attention`` (no window) with its softmax weights
    rounded to bf16 before P.V: what the f32-weights check must refuse."""
    B, H, hd = q.shape
    _, bt, K, _ = kp.shape
    nb, G = btab.shape[1], H // K
    pages = btab.long().clamp_min(0)
    kg = kp[pages].reshape(B, nb * bt, K, hd).float()
    vg = vp[pages].reshape(B, nb * bt, K, hd).float()
    live = torch.arange(nb * bt, device=q.device)[None] < lens.long()[:, None]
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, kg) / math.sqrt(hd)
    s = s.masked_fill(~live[:, None, None], -1e30)
    s_new = torch.einsum("bkgd,bkd->bkg", qg, kn.float()) / math.sqrt(hd)
    w = torch.softmax(torch.cat([s, s_new[..., None]], -1), -1)
    w = w.to(torch.bfloat16).float()
    out = torch.einsum("bkgt,btkd->bkgd", w[..., :-1], vg) \
        + w[..., -1:] * vn[:, :, None].float()
    return out.reshape(B, H, hd).to(q.dtype)


@pytest.mark.parametrize("name", ["hd120", "g32", "new-slot-neg-inside"])
def test_decode_split_keeps_f32_weights_on_card(cuda, name):
    """bf16 on the split-KV kernel against the plain version, whose
    weights are f32: no element is off by more than 2^-8 of the largest
    |plain output| and under 1% of the elements differ at all (the f32
    weights as bf16 hi + lo put it at ~0.1-0.2%).  Weights rounded to
    bf16 change far more of them."""
    args, window = _card_decode_inputs(CARD_DECODE_CASES, name,
                                       torch.bfloat16, cuda, seed=13)
    assert not window
    got = ops.paged_attention(*args)
    exp = ref.paged_attention(*args)
    torch.cuda.synchronize()
    top = float(exp.float().abs().max())
    assert float((got.float() - exp.float()).abs().max()) <= top * 2 ** -8
    share = float((got != exp).float().mean())
    assert share < 0.01
    rounded = _decode_bf16_weights(*args)
    assert float((rounded != exp).float().mean()) >= 0.05


# the card's prefill cases: name -> (B, C, H, K, hd, bt, nb, ctx, window,
# neg_inside, stale_outside); the first three are PREFILL_CASES', then
# head dims 64 (granite), 120 (padded to 128), 256 and 232 (padded to
# 240: two warps share each row's columns unevenly), block sizes 24 (no
# divisor of the 64-key tile) and 32, chunks of 1 and 17, one and eight
# query heads per kv head, and windows narrower than the chunk
CARD_PREFILL_CASES = {
    name: PREFILL_CASES[name]
    for name in ("c16-window-g4", "c8-neg-inside-g4", "c16-stale-outside-g4")
}
CARD_PREFILL_CASES.update({
    "hd64-g3": (4, 64, 24, 8, 64, 16, 16, [0, 37, 128, 190], 0,
                ((2, 1),), False),
    "hd120-window": (3, 64, 32, 8, 120, 16, 12, [0, 70, 128], 100,
                     ((1, 0),), False),
    "hd256-c33": (3, 33, 8, 2, 256, 16, 12, [5, 64, 150], 0, (), True),
    "hd232-window": (3, 40, 8, 2, 232, 16, 12, [0, 77, 150], 50,
                     ((1, 2),), False),
    "bt24-window": (3, 64, 32, 8, 128, 24, 12, [0, 100, 200], 40,
                    ((2, 3),), False),
    "bt32": (3, 64, 32, 8, 128, 32, 10, [31, 160, 250], 0, ((1, 2),),
             False),
    "c1-g4": (4, 1, 32, 8, 128, 16, 8, [0, 1, 63, 127], 0, (), True),
    "c17-window": (3, 17, 32, 8, 128, 16, 12, [0, 64, 170], 20, (), False),
    "g1-window": (3, 64, 8, 8, 128, 16, 13, [0, 96, 130], 70, ((2, 0),),
                  False),
    "g8": (3, 64, 32, 4, 128, 16, 13, [0, 64, 129], 0, ((1, 1),), False),
})


def _card_prefill_inputs(name, dtype, device, seed=8):
    B, C, H, K, hd, bt, nb, ctx, window, neg, stale = CARD_PREFILL_CASES[name]
    rng = np.random.RandomState(seed)
    P, btab = _table(rng, B, nb, bt, [c + C for c in ctx], neg_inside=neg,
                     stale_outside=stale)
    arrs = _arrays(rng, [(B, C, H, hd), (P, bt, K, hd), (P, bt, K, hd),
                         (B, C, K, hd), (B, C, K, hd)])
    q, kp, vp, kn, vn = (torch.from_numpy(a).to(device, dtype) for a in arrs)
    return (q, kp, vp, torch.from_numpy(btab).to(device),
            torch.tensor(ctx, dtype=torch.int32, device=device), kn, vn), \
        window


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CARD_PREFILL_CASES))
def test_prefill_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    args, window = _card_prefill_inputs(name, dtype, cuda)
    before = dict(ops.LAUNCHES)
    got = ops.paged_prefill_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_prefill_attention"] == \
        before["paged_prefill_attention"] + 1
    # bf16 on the tensor-core kernel, f32 on the CUDA-core one
    assert ops.LAUNCHES["paged_prefill_attention_mma"] == \
        before["paged_prefill_attention_mma"] + (dtype == torch.bfloat16)
    exp = ref.paged_prefill_attention(*args, window=window)
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)


def _prefill_bf16_weights(q, kp, vp, btab, ctx, kn, vn):
    """``ref.paged_prefill_attention`` (no window) with its softmax weights
    rounded to bf16 before P.V: what the f32-weights check must refuse."""
    B, C, H, hd = q.shape
    _, bt, K, _ = kp.shape
    nb, G = btab.shape[1], H // K
    pages = btab.long().clamp_min(0)
    kg = torch.cat([kp[pages].reshape(B, nb * bt, K, hd), kn], 1).float()
    vg = torch.cat([vp[pages].reshape(B, nb * bt, K, hd), vn], 1).float()
    pos = torch.arange(nb * bt, device=q.device)
    old = (pos[None] < ctx.long()[:, None]) \
        & (btab >= 0).repeat_interleave(bt, dim=1)
    own = torch.ones(C, C, dtype=torch.bool, device=q.device).tril()
    live = torch.cat([old[:, None].expand(B, C, nb * bt),
                      own[None].expand(B, C, C)], dim=-1)
    s = torch.einsum("bckgd,btkd->bkgct", q.reshape(B, C, K, G, hd).float(),
                     kg) / math.sqrt(hd)
    s = s.masked_fill(~live[:, None, None], -1e30)
    w = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("bkgct,btkd->bckgd", w, vg)
    return out.reshape(B, C, H, hd).to(q.dtype)


@pytest.mark.parametrize("name", ["hd64-g3", "g8", "c17-window"])
def test_prefill_mma_keeps_f32_weights_on_card(cuda, name):
    """bf16 on the tensor-core kernel against the plain version, whose
    weights are f32: no element is off by more than 2^-8 of the largest
    |plain output| and under 1% of the elements differ at all.  Weights
    rounded to bf16 (the flash kernel's contract) change far more of
    them, at a window-free case."""
    args, window = _card_prefill_inputs(name, torch.bfloat16, cuda, seed=11)
    got = ops.paged_prefill_attention(*args, window=window)
    exp = ref.paged_prefill_attention(*args, window=window)
    torch.cuda.synchronize()
    top = float(exp.float().abs().max())
    assert float((got.float() - exp.float()).abs().max()) <= top * 2 ** -8
    assert float((got != exp).float().mean()) < 0.01
    if not window:
        rounded = _prefill_bf16_weights(*args)
        assert float((rounded != exp).float().mean()) >= 0.01
