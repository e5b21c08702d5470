"""PyTorch/CUDA port of the Cohet serving stack (``repro`` is the JAX
reference).  The layout mirrors ``repro``: the counterpart of
``repro/<path>`` lives at ``repro_torch/<path>``.  The package imports
torch and numpy only; CUDA kernels are built on first use
(``kernels.build``)."""
