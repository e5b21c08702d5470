"""Cohet core: coherent memory pool, unified page table, RAO, RPC.

The paper's contribution as a composable module; see DESIGN.md §2 for the
TPU adaptation map.
"""
from repro_torch.core.pool import CoherentMemoryPool          # noqa: F401
from repro_torch.core.pagetable import UnifiedPageTable, ATC  # noqa: F401
from repro_torch.core.rao import RAOEngine, RAORequest  # noqa: F401
from repro_torch.core import rpc                              # noqa: F401
