"""cctpu_torch — the PyTorch/CUDA port of cctpu.

A second package beside the JAX reference ``cctpu/``, with the same module
tree for the modules it ports. It imports torch, numpy and scipy and never
JAX. Compute is float64 by default on the CUDA device when one is present
(see ``cctpu_torch.device``); the one hand-written Hopper kernel of the
slice is the fused density-fitted J/K build (``ops/df_jk.py``).
"""

__version__ = "0.1.0"

from cctpu_torch.core.molecule import Molecule  # noqa: E402,F401
