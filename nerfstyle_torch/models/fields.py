"""Hash-grid neural field, ``style`` kind (counterpart of
``nerfstyle_tpu/models/fields.py``).

Parameters are a plain dict under the JAX keys: two hash tables
``x_density_embedder`` and ``x_color_embedder`` ([T, C] each) and four
bias-free MLPs ``density_net``, ``color1_net``, ``color2_net``,
``class_net`` (lists of [d_in, d_out] matrices).  :func:`params_from_numpy`
and :func:`params_to_numpy` carry weights between the JAX package's numpy
trees and the port's tensors.

Rendering reads the field in two halves: :func:`field_density` (density
table + density MLP) and :func:`field_color` (color table + class, color1
and color2 heads) — the view-direction (SH) input and the ``base`` field
kind are not ported yet.  The encoder sees ``(normalize(x) + 1) / 2``, the
reference's quirk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Union

import numpy as np
import torch

from ..core.types import BBox
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, hashgrid_init, hashgrid_spec
from ..ops.mlp import mlp_apply, mlp_init, trunc_exp

Params = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]

TABLE_KEYS = ("x_density_embedder", "x_color_embedder")
MLP_KEYS = ("density_net", "color1_net", "color2_net", "class_net")


@dataclass(frozen=True)
class FieldSpec:
    """Static model architecture (from NetworkConfig)."""

    grid: HashGridSpec
    class_dim: int = 0
    density_hidden_dims: int = 64
    density_hidden_layers: int = 1
    rgb_hidden_dims: int = 64
    rgb_hidden_layers: int = 2
    density_offset: float = 0.0

    @property
    def out_channels(self) -> int:
        return 3 + self.class_dim


def make_grid_spec(
    n_lvls: int,
    n_feats_per_lvl: int,
    hashmap_size: int,
    min_res: int,
    max_res_coeff: float,
    max_bound: float,
    simplex_from: int = -1,
) -> HashGridSpec:
    """Grid spec from NetworkConfig.pos_enc and the scene bound: the finest
    resolution is ``max_res_coeff * max_bound``."""
    max_res = max_res_coeff * max_bound
    per_lvl_scale = float(np.exp2(np.log2(max_res / min_res) / (n_lvls - 1)))
    return hashgrid_spec(
        num_levels=n_lvls,
        level_dim=n_feats_per_lvl,
        base_resolution=min_res,
        per_level_scale=per_lvl_scale,
        log2_hashmap_size=hashmap_size,
        simplex_from=simplex_from,
    )


def style_field_spec(grid: HashGridSpec, class_dim: int, use_dir: bool = False, **kw) -> FieldSpec:
    """Spec of the ``style`` field kind; the view-direction (SH) color input
    (``use_dir=True``) is not ported yet and raises."""
    if use_dir:
        raise NotImplementedError("the view-direction (SH) color input is not ported yet")
    return FieldSpec(grid=grid, class_dim=class_dim, **kw)


def field_init(spec: FieldSpec, generator: torch.Generator, device=None) -> Params:
    """Initialize all parameters from ``generator`` (tables uniform ±1e-4,
    MLPs He-uniform), on ``device``."""
    enc = spec.grid.output_dim
    dh, dl = spec.density_hidden_dims, spec.density_hidden_layers
    return {
        "x_density_embedder": hashgrid_init(spec.grid, generator, device),
        "x_color_embedder": hashgrid_init(spec.grid, generator, device),
        "density_net": mlp_init(generator, enc, dh, dl, 1, device),
        "color1_net": mlp_init(generator, enc, dh, dl, 16, device),
        "color2_net": mlp_init(
            generator, 16, spec.rgb_hidden_dims, spec.rgb_hidden_layers, 3, device
        ),
        "class_net": mlp_init(generator, enc, dh, dl, spec.class_dim, device),
    }


def params_from_numpy(tree: Dict[str, object], device=None) -> Params:
    """JAX param tree (dict of numpy arrays / lists of arrays) -> port params."""
    def conv(v):
        return torch.tensor(np.asarray(v), dtype=torch.float32, device=device)

    missing = set(TABLE_KEYS + MLP_KEYS) - set(tree)
    if missing:
        raise KeyError(f"param tree lacks {sorted(missing)}")
    params: Params = {k: conv(tree[k]) for k in TABLE_KEYS}
    for k in MLP_KEYS:
        params[k] = [conv(w) for w in tree[k]]
    return params


def params_to_numpy(params: Params) -> Dict[str, object]:
    """Port params -> JAX-layout tree of numpy arrays."""
    out: Dict[str, object] = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = [w.detach().cpu().numpy() for w in v]
    return out


def _encoder_input(bbox: BBox, pts: torch.Tensor) -> torch.Tensor:
    """bbox-normalize to [0, 1], then the reference's (x + 1) / 2."""
    return (bbox.normalize(pts) + 1.0) / 2.0


def field_density(
    spec: FieldSpec,
    params: Params,
    bbox: BBox,
    pts: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Density-only forward: [M, 3] world points -> [M] sigmas."""
    x = _encoder_input(bbox, pts)
    h = hashgrid_encode(spec.grid, params["x_density_embedder"], x, plain=plain)
    out = mlp_apply(params["density_net"], h, compute_dtype=compute_dtype)
    return trunc_exp(out[:, 0] + spec.density_offset)


def field_color(
    spec: FieldSpec,
    params: Params,
    bbox: BBox,
    pts: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Color-branch-only forward: [M, 3] world points -> [M, 3 + class_dim]
    channels (sigmoid rgb, then raw class logits)."""
    x = _encoder_input(bbox, pts)
    h = hashgrid_encode(spec.grid, params["x_color_embedder"], x, plain=plain)
    classes = mlp_apply(params["class_net"], h, compute_dtype=compute_dtype)
    color1 = mlp_apply(params["color1_net"], h, compute_dtype=compute_dtype)
    rgb = mlp_apply(
        params["color2_net"], color1, output_activation="sigmoid", compute_dtype=compute_dtype
    )
    return torch.cat([rgb, classes], dim=-1)
