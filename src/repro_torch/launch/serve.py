"""Serving launcher: batched requests through the Cohet RPC front-end, on
the port's serving engine.

``python -m repro_torch.launch.serve --requests 8`` serves a reduced
mistral-nemo-12b (``--arch granite-moe-3b-a800m``: a reduced granite MoE,
dropless routing unless ``--moe-routing capacity``; ``--arch
h2o-danube-3-4b``: a reduced sliding-window model, window 16, on the paged
plane; ``--arch zamba2-7b``: a reduced zamba2 hybrid on the dense-cache
plane), as the JAX launcher does, on the CUDA card (``--device cpu`` for
the plain PyTorch path), submits wire-encoded requests, drains them
through chunked (``--prefill-chunk 0``: one-shot) prefill and batched
paged decode (the hybrid: one-shot prefill into the dense cache and
batched dense decode), and reports tokens, scheduler stats and the
SimCXL-projected CXL-NIC vs PCIe-NIC host cost.  ``--prefix-cache``
(with ``--shared-prefix-len``) shares the pages of a common prompt prefix
copy-on-write.  ``--kv-overcommit`` / ``--kv-near-blocks`` (with
``--kv-demote-after``) serve from a near tier smaller than the pool,
spilling cold pages to the far tier.  ``--arrival poisson|bursty`` drives
the asyncio engine through the trace-driven load generator instead of the
all-at-once sync drain.  ``--disagg`` and ``--prefill-slots``, whose plane
is not ported yet, are accepted by name and refused with the slice that
brings them.  Exits non-zero if any submitted request is never drained or
fails.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import rpc as wire
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.runtime.loadgen import (
    ARRIVAL_PATTERNS, make_trace, run_closed_loop,
)
from repro_torch.runtime.server import (
    AsyncBatchServer, BatchServer, encode_request,
)

RESP = {1: "int", 2: "bytes"}


def _refuse_unported(ap, args):
    later = "the port's slice for"
    checks = [
        (args.disagg, "--disagg",
         "disaggregated serving (other paged engine planes)"),
        (args.prefill_slots is not None, "--prefill-slots",
         "disaggregated serving (other paged engine planes)"),
    ]
    for bad, opt, where in checks:
        if bad:
            ap.error(f"{opt} is not ported yet: it comes with {later} "
                     f"{where}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "PyTorch versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk tokens (0 = one-shot exact-length "
                         "prefill; default: auto = min(64, max_len), "
                         "one-shot under capacity routing)")
    ap.add_argument("--prefill-buckets", type=int, default=4,
                    help="pad targets for the ragged last chunk (geometric "
                         "halves of the chunk size)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend one common random prefix of this many "
                         "tokens to every request (the shared-system-"
                         "prompt traffic --prefix-cache serves)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="copy-on-write KV prefix caching on the paged "
                         "plane: requests sharing a block-aligned token "
                         "prefix map the same refcounted pool pages "
                         "instead of re-prefilling them")
    ap.add_argument("--prefix-watermark", type=float, default=0.0,
                    help="evict LRU cached prefixes each step until this "
                         "fraction of the page pool is free (0 = evict "
                         "only on allocation pressure); requires "
                         "--prefix-cache")
    ap.add_argument("--arrival", default="all-at-once",
                    choices=ARRIVAL_PATTERNS,
                    help="all-at-once = sync drain; poisson/bursty drive "
                         "the async engine through the load generator")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="poisson arrival rate (req/s)")
    ap.add_argument("--kv-overcommit", type=float, default=1.0,
                    help="admit KV against near+far capacity: size the "
                         "near (HBM) tier at pool/FACTOR blocks and spill "
                         "cold pages to the far (CXL) tier (1.0 = no "
                         "tiering, the whole pool is near-resident)")
    ap.add_argument("--kv-near-blocks", type=int, default=None,
                    help="explicit near-tier budget in blocks (alternative "
                         "to --kv-overcommit; must be >= one slot's worth "
                         "and < the pool size to activate tiering)")
    ap.add_argument("--kv-demote-after", type=int, default=None,
                    help="override the sweep-derived demotion age: pages "
                         "untouched for this many ticks become demotion "
                         "candidates (requires active tiering)")
    # options of the JAX launcher whose planes are later slices
    ap.add_argument("--no-paged-kv", action="store_true")
    ap.add_argument("--disagg", action="store_true")
    ap.add_argument("--prefill-slots", type=int, default=None)
    ap.add_argument("--moe-routing", default="auto",
                    choices=("auto", "dropless", "capacity"),
                    help="moe archs: auto/dropless (chunked prefill by "
                         "default) or capacity (training-parity capacity-"
                         "factor drops; forces one-shot prefill)")
    args = ap.parse_args(argv)

    _refuse_unported(ap, args)
    if args.prefill_chunk is not None and args.prefill_chunk < 0:
        ap.error(f"--prefill-chunk must be >= 0, got {args.prefill_chunk}")
    if args.prefill_buckets < 1:
        ap.error(f"--prefill-buckets must be >= 1, got {args.prefill_buckets}")
    if args.shared_prefix_len < 0:
        ap.error(f"--shared-prefix-len must be >= 0, got "
                 f"{args.shared_prefix_len}")
    if args.prefix_cache and args.no_paged_kv:
        ap.error("--prefix-cache requires the paged KV plane "
                 "(drop --no-paged-kv)")
    if args.prefix_watermark and not args.prefix_cache:
        ap.error("--prefix-watermark requires --prefix-cache")
    if not 0.0 <= args.prefix_watermark < 1.0:
        ap.error(f"--prefix-watermark must be in [0, 1), got "
                 f"{args.prefix_watermark}")
    tiering = args.kv_overcommit > 1.0 or args.kv_near_blocks is not None
    if args.kv_overcommit < 1.0:
        ap.error(f"--kv-overcommit must be >= 1.0 (1.0 = no tiering), "
                 f"got {args.kv_overcommit}")
    if args.kv_near_blocks is not None and args.kv_overcommit > 1.0:
        ap.error("--kv-near-blocks and --kv-overcommit both size the "
                 "near tier; pass one")
    if args.kv_near_blocks is not None and args.kv_near_blocks < 1:
        ap.error(f"--kv-near-blocks must be >= 1, got "
                 f"{args.kv_near_blocks}")
    if args.kv_demote_after is not None and args.kv_demote_after < 1:
        ap.error(f"--kv-demote-after must be >= 1, got "
                 f"{args.kv_demote_after}")
    if args.kv_demote_after is not None and not tiering:
        ap.error("--kv-demote-after requires active tiering "
                 "(--kv-overcommit > 1 or --kv-near-blocks)")
    if tiering and args.no_paged_kv:
        ap.error("KV tiering requires the paged KV plane "
                 "(drop --no-paged-kv)")

    cfg = reduced(get_config(args.arch))
    if args.no_paged_kv and cfg.family != "hybrid":
        ap.error(f"--no-paged-kv is not ported yet for {args.arch} "
                 f"({cfg.family}): it comes with the port's slice for the "
                 f"dense-cache plane of the dense family")
    if cfg.family == "moe":
        # serving default: dropless routing, so moe joins the chunked
        # bucketed prefill pipeline; --moe-routing capacity restores the
        # training-parity capacity-factor plane (one-shot prefill only)
        routing = "dropless" if args.moe_routing == "auto" \
            else args.moe_routing
        cfg = cfg.replace(moe_routing=routing)
        if routing == "capacity" and args.prefill_chunk:
            ap.error("--prefill-chunk needs chunk-invariant routing; "
                     "capacity-factor MoE serves one-shot "
                     "(drop --moe-routing capacity or use "
                     "--prefill-chunk 0)")
    elif args.moe_routing != "auto":
        ap.error(f"--moe-routing only applies to moe-family archs "
                 f"({args.arch} is {cfg.family})")
    try:
        model = build_model(cfg)
        device = resolve_device(args.device)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        print(f"[serve] {e}", file=sys.stderr)
        sys.exit(2)
    max_len = args.shared_prefix_len + args.prompt_len + args.max_new + 2
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cls = BatchServer if args.arrival == "all-at-once" else AsyncBatchServer
    try:
        server = cls(
            model, batch_slots=args.slots, max_len=max_len,
            params=model.init(gen, device), device=device,
            paged_kv=False if args.no_paged_kv else "auto",
            prefill_chunk=("auto" if args.prefill_chunk is None
                           else args.prefill_chunk),
            prefill_buckets=args.prefill_buckets,
            prefix_cache=args.prefix_cache,
            prefix_watermark=args.prefix_watermark,
            kv_overcommit=args.kv_overcommit,
            kv_near_blocks=args.kv_near_blocks,
            kv_demote_after=args.kv_demote_after)
    except ValueError as e:
        ap.error(str(e))

    rng = np.random.RandomState(args.seed)
    shared = rng.randint(1, cfg.vocab - 1,
                         size=args.shared_prefix_len).tolist()
    wires = [encode_request(
        rid, shared + rng.randint(1, cfg.vocab - 1,
                                  size=args.prompt_len).tolist(),
        args.max_new) for rid in range(args.requests)]

    t0 = time.time()
    if args.arrival == "all-at-once":
        for w in wires:
            server.submit_wire(w)
        responses = server.run_until_drained()
        metrics = None
    else:
        # submit the wire bytes themselves so the NIC projection sees the
        # ingress deserialization traffic too
        trace = make_trace(args.arrival, args.requests, rate_rps=args.rate,
                           burst=max(1, args.slots), seed=args.seed)
        responses, metrics = run_closed_loop(server, wires, trace)
    dt = time.time() - t0

    for buf in responses:
        msg = wire.decode(buf, RESP)
        toks = np.frombuffer(msg[2], np.int32)
        print(f"req {msg[1]}: {toks.tolist()}")
    print(f"[serve] {len(responses)}/{args.requests} completed in {dt:.1f}s "
          f"on {device}; stats={server.stats}")
    if metrics is not None:
        print(f"[serve] load: {metrics.to_dict()}")
    nic = server.nic_report()["total"]
    kv = server.kv_stats()
    print(f"[serve] SimCXL NIC projection: PCIe {nic['pcie_us']:.1f}us vs "
          f"CXL {nic['cxl_us']:.1f}us ({nic['speedup_x']}x); "
          f"kv: {'paged' if kv['paged_kv'] else 'dense'} cache, "
          f"{kv['kv_tier']} tier, {kv['blocks_allocated']} blocks")
    if server.tiered:
        t = kv["tier"]
        pol = t["policy"]
        print(f"[serve] kv tiers: {t['near_resident']}/{t['near_frames']} "
              f"near, {t['far_resident']}/{t['far_frames']} far; "
              f"{t['demotions']} demoted ({t['forced_demotions']} forced), "
              f"{t['promotions']} promoted ({t['prefetch_blocks']} "
              f"prefetch, {t['demand_stall_blocks']} demand stalls); "
              f"policy: {pol['flow']} demote_after={pol['demote_after']} "
              f"batch={pol['migrate_batch']}")
    if args.prefix_cache:
        pf = kv["prefix"]
        print(f"[serve] prefix cache: {pf['hits']} hits "
              f"({pf['hit_tokens']} tokens), {pf['entries']} entries "
              f"resident, {pf['evicted']} evicted")

    undrained = args.requests - len(responses)
    if undrained or server.stats["failed"]:
        print(f"[serve] ERROR: {undrained} request(s) never drained, "
              f"{server.stats['failed']} failed", file=sys.stderr)
        sys.exit(1)
    return responses


if __name__ == "__main__":
    main()
