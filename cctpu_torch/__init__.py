"""cctpu_torch — the PyTorch/CUDA port of cctpu.

A second package beside the JAX reference ``cctpu/``, with the same module
tree for the modules it ports. It imports torch, numpy and scipy and never
JAX. Compute is float64 by default on the CUDA device, and on the CPU only
where the caller asks for it (see ``cctpu_torch.device``). The
density-fitted J/K builds run on hand-written Hopper kernels (``ops/``: the
fused closed-shell J+K, J for one or two densities, K per spin).
"""

__version__ = "0.1.0"

from cctpu_torch.core.molecule import Molecule  # noqa: E402,F401
