"""Device and dtype policy of the port, in one place.

- Compute runs on ``cuda``. The CPU is used only where the caller asks
  for it (``device="cpu"`` in the API, ``--device cpu`` in the CLI): with
  no card and no such request, ``default_device`` raises rather than
  carry on on the CPU. A tensor that lives on the card stays there: no
  code path of the port moves work to the CPU behind the caller's back.
- float64 is the default type. The H100 has native FP64, so the port keeps
  none of the reference's f32/bf16 workarounds for a device without it.
- TF32 is off for matmuls and cuDNN: a float32 product on the card is a
  true float32 product (TF32 keeps ~3 decimal digits, which breaks the
  SCF's DIIS floor the same way single-pass bf16 did on the TPU).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPE = torch.float64


def default_device(device=None) -> torch.device:
    """``device`` as a torch device, ``cuda`` when it is None; raises when
    that is a CUDA device and none is present (ask for the CPU with
    ``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: cctpu_torch runs on the card unless asked for "
            "the CPU (device=\"cpu\", or --device cpu in the CLI)")
    return dev


def as_tensor(x, device=None, dtype=DTYPE) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` on ``device`` (default: the card)."""
    return torch.as_tensor(x, dtype=dtype, device=default_device(device))
