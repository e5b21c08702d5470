"""SimCXL: transaction-level, hardware-calibrated CXL simulator (see DESIGN.md).

Two evaluation paths share the same calibrated constants:

* the discrete-event models (``engine``/``lsu``/``link``/``nic``) — exact,
  transaction-by-transaction, the golden reference;
* the vectorized batch engine (``batch``) — closed-form array evaluation
  of the same flows for large parameter sweeps, cross-validated against
  the DES to <= 1e-6 relative error (``sweep()`` is the entry point).
"""
from repro_torch.simcxl.params import FPGA_400MHZ, ASIC_1_5GHZ, SimCXLParams  # noqa
from repro_torch.simcxl.batch import (  # noqa: F401
    SweepPoint, SweepResult, frequency_sweep, grid, sweep,
)
