"""mom6_torch — the PyTorch/CUDA port of ``mom6_tpu``.

The same halo-padded ``(nk, njh, nih)`` layout, field names and
algorithms as the JAX package, so every tensor compares element for
element with its ``mom6_tpu`` counterpart.  Plain tensor code is
PyTorch; the three kernel families that ``mom6_tpu`` wrote in Pallas
(continuity sweep, BT_cont curve fit, barotropic subcycle) are
hand-written CUDA kernels under ``csrc/``, compiled with ``nvcc`` at
first use.  A tensor on the CPU takes each kernel's plain PyTorch
version instead.
"""

__version__ = "0.1.0"
