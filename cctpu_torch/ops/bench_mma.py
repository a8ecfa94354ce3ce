"""Fragment layouts and issue rates of the FP64 tensor-core instructions
on the card (``csrc/mma_layout.cu``).

    python -m cctpu_torch.ops.bench_mma

Prints the card's name and power limit, then one JSON line per shape
(m8n8k4, m16n8k4, m16n8k8, m16n8k16): the relative error of one product
under the documented layout against torch.matmul, and the TFLOP/s of every
SM issuing independent products (one block of 16, 8 or 4 warps an SM, 8
accumulators a warp, CUDA events).
"""

import ctypes
import sys

import numpy as np
import torch

from cctpu_torch.ops import build
from cctpu_torch.utils import measure

SHAPES = {884: (8, 4), 1684: (16, 4), 1688: (16, 8), 16816: (16, 16)}


def load():
    lib = build.load("mma_layout")
    lib.mma_layout_f64.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.mma_layout_f64.restype = ctypes.c_int
    lib.mma_rate_f64.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.mma_rate_f64.restype = ctypes.c_int
    return lib


def layout_error(lib, shape, dev, seed=5) -> float:
    """Relative error of one ``shape`` product against torch.matmul."""
    m, k = SHAPES[shape]
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((m, k)), device=dev)
    b = torch.as_tensor(rng.standard_normal((k, 8)), device=dev)
    c = torch.zeros((m, 8), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mma_layout_f64(shape, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                             stream)
    if err != 0:
        raise RuntimeError(f"mma_layout_f64({shape}) failed: {err}")
    torch.cuda.synchronize()
    return measure.rel_err(c, a @ b)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("bench_mma: no CUDA device")
    dev = torch.device("cuda", 0)
    measure.emit(measure.card_line())
    lib = load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(1, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    iters = 20000
    for shape, (m, k) in SHAPES.items():
        rates = {}
        for warps in (16, 8, 4):
            ms = measure.cuda_ms(lambda: lib.mma_rate_f64(
                shape, sms, warps, iters, out.data_ptr(), stream), 5)
            rates[warps] = sms * warps * iters * 8 * 2.0 * m * 8 * k / ms / 1e9
        measure.emit({"mma": shape,
                      "layout_rel_err": layout_error(lib, shape, dev),
                      "tflops_by_warps_per_sm": rates})
    return 0


if __name__ == "__main__":
    sys.exit(main())
