"""Serving launcher: batched requests through the Cohet RPC front-end, on
the port's paged KV engine.

``python -m repro_torch.launch.serve --requests 8`` serves a reduced
mistral-nemo-12b, as the JAX launcher does, on the CUDA card
(``--device cpu`` for the plain PyTorch path), submits wire-encoded
requests, drains them through chunked prefill and batched paged decode,
and reports tokens, scheduler stats and the SimCXL-projected CXL-NIC vs
PCIe-NIC host cost.  The options of the JAX launcher that belong to
planes not ported yet are accepted by name and refused with the slice
that brings them.  Exits non-zero if any submitted request is never
drained or fails.
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
from repro_torch.runtime.server import BatchServer, encode_request

RESP = {1: "int", 2: "bytes"}
ARRIVAL_PATTERNS = ("all-at-once", "poisson", "bursty")


def _refuse_unported(ap, args):
    later = "the port's slice for"
    checks = [
        (args.arrival != "all-at-once", f"--arrival {args.arrival}",
         "the asyncio engine (other paged engine planes)"),
        (args.no_paged_kv, "--no-paged-kv", "the dense-cache plane"),
        (args.prefill_chunk == 0, "--prefill-chunk 0",
         "one-shot prefill (other paged engine planes)"),
        (args.prefix_cache, "--prefix-cache",
         "the prefix cache (other paged engine planes)"),
        (bool(args.prefix_watermark), "--prefix-watermark",
         "the prefix cache (other paged engine planes)"),
        (args.kv_overcommit != 1.0, "--kv-overcommit",
         "KV tiering (other paged engine planes)"),
        (args.kv_near_blocks is not None, "--kv-near-blocks",
         "KV tiering (other paged engine planes)"),
        (args.kv_demote_after is not None, "--kv-demote-after",
         "KV tiering (other paged engine planes)"),
        (args.disagg, "--disagg",
         "disaggregated serving (other paged engine planes)"),
        (args.prefill_slots is not None, "--prefill-slots",
         "disaggregated serving (other paged engine planes)"),
        (args.moe_routing != "auto", "--moe-routing",
         "MoE on the paged plane"),
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
                    help="prefill chunk tokens (default: auto = "
                         "min(64, max_len))")
    ap.add_argument("--prefill-buckets", type=int, default=4,
                    help="pad targets for the ragged last chunk (geometric "
                         "halves of the chunk size)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend one common random prefix of this many "
                         "tokens to every request")
    # options of the JAX launcher whose planes are later slices
    ap.add_argument("--arrival", default="all-at-once",
                    choices=ARRIVAL_PATTERNS)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--no-paged-kv", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefix-watermark", type=float, default=0.0)
    ap.add_argument("--kv-overcommit", type=float, default=1.0)
    ap.add_argument("--kv-near-blocks", type=int, default=None)
    ap.add_argument("--kv-demote-after", type=int, default=None)
    ap.add_argument("--disagg", action="store_true")
    ap.add_argument("--prefill-slots", type=int, default=None)
    ap.add_argument("--moe-routing", default="auto",
                    choices=("auto", "dropless", "capacity"))
    args = ap.parse_args(argv)

    _refuse_unported(ap, args)
    if args.prefill_chunk is not None and args.prefill_chunk < 0:
        ap.error(f"--prefill-chunk must be >= 0, got {args.prefill_chunk}")
    if args.prefill_buckets < 1:
        ap.error(f"--prefill-buckets must be >= 1, got {args.prefill_buckets}")
    if args.shared_prefix_len < 0:
        ap.error(f"--shared-prefix-len must be >= 0, got "
                 f"{args.shared_prefix_len}")

    cfg = reduced(get_config(args.arch))
    try:
        model = build_model(cfg)
        device = resolve_device(args.device)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        print(f"[serve] {e}", file=sys.stderr)
        sys.exit(2)
    max_len = args.shared_prefix_len + args.prompt_len + args.max_new + 2
    gen = torch.Generator(device=device).manual_seed(args.seed)
    server = BatchServer(model, batch_slots=args.slots, max_len=max_len,
                         params=model.init(gen, device), device=device,
                         prefill_chunk=("auto" if args.prefill_chunk is None
                                        else args.prefill_chunk),
                         prefill_buckets=args.prefill_buckets)

    rng = np.random.RandomState(args.seed)
    shared = rng.randint(1, cfg.vocab - 1,
                         size=args.shared_prefix_len).tolist()
    wires = [encode_request(
        rid, shared + rng.randint(1, cfg.vocab - 1,
                                  size=args.prompt_len).tolist(),
        args.max_new) for rid in range(args.requests)]

    t0 = time.time()
    for w in wires:
        server.submit_wire(w)
    responses = server.run_until_drained()
    dt = time.time() - t0

    for buf in responses:
        msg = wire.decode(buf, RESP)
        toks = np.frombuffer(msg[2], np.int32)
        print(f"req {msg[1]}: {toks.tolist()}")
    print(f"[serve] {len(responses)}/{args.requests} completed in {dt:.1f}s "
          f"on {device}; stats={server.stats}")
    nic = server.nic_report()["total"]
    print(f"[serve] SimCXL NIC projection: PCIe {nic['pcie_us']:.1f}us vs "
          f"CXL {nic['cxl_us']:.1f}us ({nic['speedup_x']}x); "
          f"kv: {server.kv_stats()['kv_tier']} tier, "
          f"{server.kv_stats()['blocks_allocated']} blocks")

    undrained = args.requests - len(responses)
    if undrained or server.stats["failed"]:
        print(f"[serve] ERROR: {undrained} request(s) never drained, "
              f"{server.stats['failed']} failed", file=sys.stderr)
        sys.exit(1)
    return responses


if __name__ == "__main__":
    main()
