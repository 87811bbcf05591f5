"""Spherical-harmonics direction encoding (counterpart of
``nerfstyle_tpu/ops/sh.py``).

The real SH basis of degree 1-4 with tiny-cuda-nn's constants, evaluated on
directions given in [0, 1] (the field passes ``(dirs + 1) / 2``) and mapped
back to [-1, 1] first: ``d01 * 2 - 1``, which is not the identity in fp32
and is kept as JAX computes it.  Output [M, degree**2].

:func:`sh_encode` launches kernel K5d (``csrc/sh.cu``) on CUDA tensors and
runs :func:`sh_encode_plain` on CPU tensors or with ``plain=True``.  Both
round every product and sum on its own, in the JAX order of operations, so
the kernel gives the plain version's bits.  The directions take no
gradient on any path: on CUDA a direction tensor that asks for one raises.
"""

from __future__ import annotations

import torch

from .. import kernels, use_kernel

SH_MAX_DEGREE = 4


def _check_degree(degree: int) -> None:
    if not 1 <= degree <= SH_MAX_DEGREE:
        raise ValueError(f"sh_encode supports degrees 1..{SH_MAX_DEGREE}, got {degree}")


def sh_encode_plain(dirs01: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Plain K5d: [..., 3] directions in [0, 1] -> [..., degree**2]."""
    _check_degree(degree)
    d = dirs01 * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree >= 3:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * x * y * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)


def sh_encode(dirs01: torch.Tensor, degree: int = 4, *, plain: bool = False) -> torch.Tensor:
    """SH basis of [M, 3] directions in [0, 1] -> [M, degree**2] float32.

    CUDA tensors go through kernel K5d, which takes no gradient and raises
    on directions that require one; CPU tensors (or ``plain=True``) through
    :func:`sh_encode_plain`."""
    _check_degree(degree)
    if not use_kernel(dirs01, plain):
        return sh_encode_plain(dirs01, degree)
    if dirs01.requires_grad:
        raise ValueError("sh_encode: K5d takes no gradient of the directions, and these "
                         "require one")
    return kernels.sh_encode(dirs01.contiguous(), degree)
