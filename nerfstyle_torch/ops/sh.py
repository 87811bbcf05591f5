"""Spherical-harmonics direction encoding (counterpart of
``nerfstyle_tpu/ops/sh.py``).

The real SH basis of degree 1-4 with tiny-cuda-nn's constants, evaluated on
directions given in [0, 1] (the field passes ``(dirs + 1) / 2``) and mapped
back to [-1, 1] first: ``d01 * 2 - 1``, which is not the identity in fp32
and is kept as JAX computes it.  Output [M, degree**2].

:func:`sh_assemble` builds a color MLP's whole input from features and raw
view directions: the features, the basis of ``(dirs + 1) / 2`` as the
fields read it, and zero columns up to the width K5 takes, as one tensor.

:func:`sh_encode` and :func:`sh_assemble` launch kernel K5d's two entries
(``csrc/sh.cu``) on CUDA tensors and run :func:`sh_encode_plain` and
:func:`sh_assemble_plain` on CPU tensors or with ``plain=True``.  Both
round every product and sum on its own, in the JAX order of operations, so
the kernel gives the plain version's bits.  The directions take no
gradient: on CUDA a direction tensor that asks for one raises (on the CPU
``sh_assemble`` hands it none).
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


def sh_assemble_plain(feat: torch.Tensor, dirs: torch.Tensor, degree: int,
                      width: int) -> torch.Tensor:
    """Plain K5d assemble: ``[feat, sh_encode_plain((dirs + 1) / 2), 0...]``
    [M, width]."""
    basis = sh_encode_plain((dirs + 1.0) / 2.0, degree)
    pad = feat.new_zeros((feat.shape[0], width - feat.shape[1] - degree**2))
    return torch.cat([feat, basis, pad], dim=-1)


class ShAssemble(torch.autograd.Function):
    """K5d assemble, forward on either path; the backward hands the input
    gradient's first k columns to ``feat`` (no kernel) and none to the
    directions."""

    @staticmethod
    def forward(ctx, feat, dirs, degree, width, plain):
        ctx.k = feat.shape[1]
        if not use_kernel(feat, plain):
            return sh_assemble_plain(feat, dirs, degree, width)
        return kernels.sh_assemble(feat, dirs.contiguous(), degree, width)

    @staticmethod
    def backward(ctx, g):
        return g[:, :ctx.k], None, None, None, None


def sh_assemble(feat: torch.Tensor, dirs: torch.Tensor, degree: int, width: int, *,
                plain: bool = False) -> torch.Tensor:
    """[M, k] features and [M, 3] view directions -> [M, width]: the
    features, the SH basis of ``(dirs + 1) / 2`` and zero columns.

    CUDA tensors go through K5d's second entry in one launch (``feat`` a
    unit column stride and any row stride: a column slice of a wider
    tensor), which raises on directions that require a gradient; CPU
    tensors (or ``plain=True``) through :func:`sh_assemble_plain`.
    Differentiable in ``feat`` only."""
    _check_degree(degree)
    k = feat.shape[1]
    if width < k + degree**2:
        raise ValueError(f"sh_assemble: width {width} holds fewer than the {k} features and "
                         f"{degree**2} basis columns")
    if use_kernel(feat, plain) and dirs.requires_grad:
        raise ValueError("sh_assemble: K5d takes no gradient of the directions, and these "
                         "require one")
    return ShAssemble.apply(feat, dirs, degree, width, plain)
