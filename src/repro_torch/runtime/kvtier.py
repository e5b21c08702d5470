"""KV tiering policy, derived from the calibrated SimCXL sweep model.

The tiered pager (``runtime.scheduler.KVBlockPager``) needs three policy
parameters: how long a page must sit untouched before it is demotion-
eligible (``demote_after`` ticks), how many blocks one migration event
may move (``migrate_batch``), and how much near-tier headroom the
proactive demoter maintains (``near_watermark``).  None of these are
hand-tuned constants — ``derive_policy`` scores candidate migration
granularities against ``simcxl.batch.sweep``, the same hardware-
calibrated latency model the paper validates (CXL.cache vs cxl.io.dma:
68% latency cut, 14.4x bandwidth at cacheline granularity), and turns
the winning flow's cost into thresholds:

* **flow + migrate_batch** — a demotion writes ``block_bytes`` per page
  into the far tier.  Candidate (flow, batch) points are swept in
  bandwidth mode: cxl.cache as a stream of cacheline writes, cxl.io.dma
  as one DMA descriptor per block.  The cheapest per-block cost picks
  both the fabric flow and the batch size at which that cost saturates.
* **demote_after** — a demotion is worth it when the migration cost is
  recouped by freeing a near frame.  A wrongly-demoted page costs one
  promotion (same price) plus far-tier reads never happen (the pager
  promotes before dispatch), so the break-even age is the round-trip
  migration cost divided by the per-tick far-minus-near residency
  penalty of the tokens in one block.
* **near_watermark** — keep enough near frames free that an allocation
  burst is absorbed by prior proactive demotions instead of forced
  synchronous ones: the fraction of migration cost relative to the cost
  of touching a block's tokens near.

All outputs are clamped to sane scheduler ranges so a degenerate
parameter set (e.g. zero-latency far tier) cannot wedge the pager.
"""
from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Tuple

from repro_torch.simcxl.batch import SweepPoint, sweep
from repro_torch.simcxl.params import FPGA_400MHZ, SimCXLParams


@dataclass(frozen=True)
class TierPolicy:
    """Demotion policy for the tiered KV pager (see module docstring)."""
    demote_after: int        # ticks untouched before demotion-eligible
    migrate_batch: int       # max blocks per proactive migration event
    near_watermark: float    # keep this fraction of near frames free
    demote_block_ns: float   # projected cost of demoting one block
    flow: str                # winning fabric flow ("cxl.cache"/"cxl.io.dma")

    def to_dict(self):
        return asdict(self)


def _per_block_ns(flow: str, block_bytes: int, n_blocks: int,
                  params: SimCXLParams) -> float:
    """Projected steady-state cost of moving one block in a batch of
    ``n_blocks``, on ``flow``.  cxl.cache streams cachelines; cxl.io.dma
    issues one descriptor per block."""
    line = int(params.line_bytes)
    if flow == "cxl.cache":
        n_lines = max(1, -(-n_blocks * block_bytes // line))
        pt = SweepPoint("cxl.cache", "mem", mode="bandwidth", size=line,
                        n_requests=n_lines, params=params)
    else:
        pt = SweepPoint("cxl.io.dma", mode="bandwidth", size=block_bytes,
                        n_requests=n_blocks, params=params)
    res = sweep([pt])
    bw = max(float(res.bandwidth_GBs[0]), 1e-12)   # bytes/ns
    return block_bytes / bw


def derive_policy(block_bytes: int, *, params: SimCXLParams = FPGA_400MHZ,
                  block_tokens: int = 16,
                  batches: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                  ) -> TierPolicy:
    """Score candidate (flow, batch) demotion granularities on the sweep
    model and derive the pager's policy thresholds from the winner."""
    block_bytes = max(1, int(block_bytes))
    best = None   # (per_block_ns, batch, flow)
    for flow in ("cxl.cache", "cxl.io.dma"):
        # descending batch order: at equal per-block cost prefer the
        # larger batch (amortizes per-event scheduler overhead)
        for n in sorted(batches, reverse=True):
            cost = _per_block_ns(flow, block_bytes, n, params)
            if best is None or cost < best[0] - 1e-9:
                best = (cost, n, flow)
    demote_block_ns, migrate_batch, flow = best

    # per-token residency penalty: far-tier access vs the device-local
    # HMC hit (numa_extra_ns[0] = nearest CXL hop)
    near_ns = params.dcyc(params.hmc_hit_cycles)
    far_ns = params.lat_mem_hit + params.numa_extra_ns[0]
    penalty_ns = max((far_ns - near_ns) * block_tokens, 1e-9)
    # break-even age for a demote+promote round trip, in ticks
    demote_after = int(round(2.0 * demote_block_ns / penalty_ns))
    demote_after = min(32, max(2, demote_after))

    # headroom: migration cost relative to the near-tier touch cost of a
    # block's tokens — costlier migrations justify more free headroom
    near_watermark = demote_block_ns / (demote_block_ns
                                        + near_ns * block_tokens)
    near_watermark = min(0.5, max(1.0 / 16.0, near_watermark))

    return TierPolicy(demote_after=demote_after,
                      migrate_batch=int(migrate_batch),
                      near_watermark=float(near_watermark),
                      demote_block_ns=float(demote_block_ns),
                      flow=flow)
