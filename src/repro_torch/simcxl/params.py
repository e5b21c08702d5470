"""Hardware-calibrated SimCXL parameters.

The paper calibrates SimCXL against a real testbed (Intel Agilex-I CXL-FPGA
@400 MHz + Samsung CXL expander on a Xeon 8468V, Table I) to a 3% mean
absolute percentage error.  We have no hardware, so the *paper's published
measurements* (Figs 12–16 and §VI text) serve as the testbed; constants below
are decomposed into device-clock cycles (scale with frequency: 400 MHz FPGA
vs 1.5 GHz ASIC) and host-side nanoseconds (fixed), exactly the paper's
frequency-scaling methodology (§VI-A2).

Reference values carried in ``calibration.py``; tests assert MAPE <= 3%.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

NS = 1.0
US = 1000.0
CACHELINE = 64


@dataclass(frozen=True)
class SimCXLParams:
    # ---- clocks ----
    device_freq_hz: float = 400e6          # FPGA; 1.5e9 models the ASIC
    host_freq_hz: float = 2.4e9            # testbed pinned at 2.4 GHz

    # ---- CXL.cache D2H load path (decomposed; see Fig 13) ----
    # HMC hit = pure device cycles: 46 cyc @400MHz = 115 ns
    hmc_hit_cycles: int = 46
    # HMC miss -> PCIe traversal + host LLC directory: host-side fixed ns
    pcie_traversal_ns: float = 390.0       # device->LLC->device (both ways)
    llc_access_ns: float = 70.6            # directory + LLC read
    dram_access_ns: float = 112.7          # LLC miss -> DRAM (Fig 13: 688.3-575.6)

    # ---- issue intervals (pipelining / bandwidth; Fig 15) ----
    # HMC streaming: 97.9% of 25.6 GB/s theoretical -> 2.553 ns/line
    hmc_issue_ns: float = 2.553
    # host-routed path: coherence-check pipeline bubbles (paper: 55%/52.7%)
    llc_issue_ns: float = 4.539            # -> 14.10 GB/s
    mem_issue_ns: float = 4.744            # -> 13.49 GB/s

    # ---- NUMA (Fig 12): added ns per node distance, node7 nearest ----
    numa_extra_ns: Tuple[float, ...] = (69.7, 72.7, 81.7, 87.7,
                                        21.7, 19.7, 4.7, 0.0)
    numa_jitter_ns: float = 18.0           # IQR-ish spread seen on testbed

    # ---- CXL.io DMA (Figs 14/16) ----
    dma_setup_ns: float = 2450.0           # per-transfer engine setup (latency)
    dma_stream_bw_GBs: float = 22.9        # streaming ceiling (pipelined)
    dma_per_msg_overhead_ns: float = 69.5  # pipelined per-message issue cost
    dma_wire_bw_GBs: float = 25.6          # PCIe5 x16 payload ceiling @400MHz IP

    # ---- MMIO ----
    mmio_write_ns: float = 280.0           # posted, one outstanding
    mmio_read_ns: float = 850.0

    # ---- HMC geometry ----
    hmc_size_bytes: int = 128 * 1024
    hmc_ways: int = 4
    line_bytes: int = CACHELINE

    # ---- RAO (Section V-A; NIC PEs) ----
    rao_pe_cycles: int = 4                 # read-modify-write in PE
    rao_pcie_read_ns: float = 2450.0       # DMA read for RAO (one line)
    rao_pcie_write_ns: float = 1208.0      # write + ack before next op (RAW)
    n_rao_pes: int = 4

    # ---- RPC (Section V-B); constants fitted to Fig 18, see nic.py ----
    rpc_parser_bw_GBs: float = 1.45        # (de)serializer byte throughput
    rpc_field_cycles: float = 1.0          # en/decode cycles per field
    rpc_deref_ns: float = 10.0             # decoder pointer-deref per level
    rpc_ncp_push_ns: float = 10.0          # NC-P per line into LLC, pipelined
    rpc_temp_buf_bytes: int = 4096         # RpcNIC on-chip temp buffer
    rpc_ring_dma_ns: float = 1500.0        # RpcNIC ring head update via DMA
    rpc_dsa_setup_ns: float = 5712.0       # DSA invocation + completion wait
    rpc_dsa_per_field_ns: float = 38.8     # DSA gather of noncontiguous field
    rpc_cxl_mem_write_ns: float = 30.0     # CPU store per field (CXL.mem)
    rpc_host_vs_cxlmem: float = 1.08       # paper: CXL.mem construct +8%
    rpc_wc_bw_GBs: float = 6.0             # write-combined payload stream
    rpc_fetch_outstanding: float = 9.92    # DCOH outstanding line fetches
    rpc_fetch_field_ns: float = 75.79      # per-field fetch overhead (cold)
    rpc_fetch_field_pf_ns: float = 50.4    # ... when the prefetcher hits
    rpc_chase_ns: float = 90.4             # serialized chase per nest level
    rpc_streams_per_nest: float = 2.47     # prefetch streams broken per level

    @property
    def cyc_ns(self) -> float:
        return 1e9 / self.device_freq_hz

    def dcyc(self, n: int) -> float:
        """n device cycles in ns."""
        return n * self.cyc_ns

    # convenience single-access latencies (Fig 13)
    @property
    def lat_hmc_hit(self) -> float:
        return self.dcyc(self.hmc_hit_cycles)

    @property
    def lat_llc_hit(self) -> float:
        return self.lat_hmc_hit + self.pcie_traversal_ns + self.llc_access_ns

    @property
    def lat_mem_hit(self) -> float:
        return self.lat_llc_hit + self.dram_access_ns

    def at_freq(self, hz: float) -> "SimCXLParams":
        return replace(self, device_freq_hz=hz)


FPGA_400MHZ = SimCXLParams()
ASIC_1_5GHZ = SimCXLParams(device_freq_hz=1.5e9)
