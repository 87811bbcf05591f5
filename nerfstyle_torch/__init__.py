"""nerfstyle_torch: the PyTorch/CUDA port of nerfstyle for one NVIDIA H100.

It mirrors the layout of the JAX package ``nerfstyle_tpu`` (``core``,
``data``, ``ops``, ``models``, ``render``, ``training``) so that each module
has a counterpart there, reads and writes the same ``.npz`` checkpoints, and
runs its kernels as hand-written CUDA for Hopper (``csrc/``, loaded by
``kernels``).  It imports torch, numpy and the standard library only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    an entry point never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nerfstyle_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_kernel(t: torch.Tensor, plain: bool = False) -> bool:
    """Dispatch rule of every kernel wrapper: True -> launch the CUDA kernel,
    False -> run the plain PyTorch version.  The plain version runs for a
    CPU tensor, or when the caller asks for it (``plain=True``) as the
    reference a kernel is checked against; any other device raises."""
    if plain or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {t.device}")
