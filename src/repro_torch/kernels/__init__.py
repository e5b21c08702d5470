"""Attention kernels of the paged serving path: hand-written CUDA for
Hopper (``csrc/``), their plain PyTorch versions (``ref``) and the
wrappers that route between them (``ops``)."""
