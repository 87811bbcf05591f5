"""Hash-grid neural fields (counterpart of ``nerfstyle_tpu/models/fields.py``).

Two kinds, as in JAX.  ``style`` (the reference's StyleTCNerf, the model
the trainers build): two hash tables ``x_density_embedder`` and
``x_color_embedder`` ([T, C] each) and four bias-free MLPs
``density_net``, ``color1_net``, ``color2_net``, ``class_net``; with
``use_dir`` color2 reads color1's 16 outputs and the SH basis of the view
direction.  ``base`` (the reference's TCNerf, reached through the library
API only, as in JAX): one table ``x_embedder``, ``density_net`` (its first
output the density, the other ``density_out_dims - 1`` the color head's
features) and ``rgb_net`` on those features and the direction's SH basis.
MLPs are lists of [d_in, d_out] matrices.  :func:`params_from_numpy` and
:func:`params_to_numpy` carry weights between the JAX package's numpy trees
and the port's tensors.

Every MLP goes through :func:`~nerfstyle_torch.ops.mlp.mlp_apply` (kernel K5
on CUDA tensors); the color head's input under a view direction (features,
the direction's SH basis and K5's zero padding) through
:func:`~nerfstyle_torch.ops.sh.sh_assemble` (kernel K5d, one launch).
Rendering reads the field in two halves: :func:`field_density` (density
table + density MLP) and :func:`field_color` (the style kind's color table
+ class, color1 and color2 heads; the base kind has no density-free color
path and runs :func:`field_apply`); a train step's phase B reads it whole
with :func:`field_apply`, for the style kind one encode of the
concatenated ``[T, 4]`` tables.  All three are differentiable in the
params; the directions (``dirs``, [M, 3], read where the spec has a
view-direction input) take no gradient.  The encoder sees ``(normalize(x) + 1) / 2``, the
reference's quirk.

:func:`train_state_from_numpy` and :func:`train_state_to_numpy` carry a
trainer's params, optimizer state and EMA between the JAX package's numpy
trees and the port's tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import kernels
from ..config import ConfigError
from ..core.types import BBox
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, hashgrid_init, hashgrid_spec
from ..ops.mlp import kernel_in_width, mlp_apply, mlp_init, pad_weights, trunc_exp
from ..ops.sh import sh_assemble
from ..training.ema import EmaState
from ..training.optim import OptState, opt_state_from_tree

Params = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]

# Param keys of each field kind: its tables, then its MLPs.
TABLE_KEYS = ("x_density_embedder", "x_color_embedder")
MLP_KEYS = ("density_net", "color1_net", "color2_net", "class_net")
BASE_TABLE_KEYS = ("x_embedder",)
BASE_MLP_KEYS = ("density_net", "rgb_net")
KINDS = ("style", "base")


@dataclass(frozen=True)
class FieldSpec:
    """Static model architecture (from NetworkConfig), with JAX's defaults."""

    grid: HashGridSpec
    class_dim: int = 0
    use_dir: bool = False
    sh_degree: int = 4
    density_hidden_dims: int = 64
    density_hidden_layers: int = 1
    density_out_dims: int = 16  # the base kind only
    rgb_hidden_dims: int = 64
    rgb_hidden_layers: int = 2
    kind: str = "style"  # "style" (StyleTCNerf) | "base" (TCNerf)
    density_offset: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"field kind {self.kind!r} is not one of {KINDS}")

    @property
    def out_channels(self) -> int:
        return 3 + self.class_dim if self.kind == "style" else 3

    @property
    def needs_dirs(self) -> bool:
        """True where the color head reads the view direction: the style
        kind under ``use_dir``, the base kind always."""
        return self.use_dir or self.kind == "base"

    @property
    def rgb_in_dims(self) -> int:
        """Input width of the last color MLP (color2_net or rgb_net)."""
        if self.kind == "base":
            return self.density_out_dims - 1 + self.sh_degree**2
        return 16 + (self.sh_degree**2 if self.use_dir else 0)


def _check_kernel_shapes(device, *, density_hidden_dims: int, density_hidden_layers: int,
                         rgb_hidden_dims: int, rgb_hidden_layers: int, n_lvls: int,
                         n_feats_per_lvl: int, rgb_in_dims: int = 16) -> None:
    """On a CUDA device, raise ConfigError listing each network flag whose
    value the CUDA kernels do not take, with the range it may take: K5's
    hidden width, hidden depths and input widths (csrc/mlp.cu; the color
    head's input ``rgb_in_dims`` is padded up to 32 and may not exceed it),
    K1/K2's table row widths (csrc/hashgrid.cu).  The CPU path takes any
    value."""
    if torch.device(device).type != "cuda":
        return
    errors = []
    for flag, v in (("density_hidden_dims", density_hidden_dims),
                    ("rgb_hidden_dims", rgb_hidden_dims)):
        if v != kernels.MLP_HIDDEN:
            errors.append(f"--{flag} {v}: the CUDA MLP kernel takes {kernels.MLP_HIDDEN}")
    for flag, v in (("density_hidden_layers", density_hidden_layers),
                    ("rgb_hidden_layers", rgb_hidden_layers)):
        if v not in kernels.MLP_HIDDEN_LAYERS:
            errors.append(f"--{flag} {v}: the CUDA MLP kernel takes "
                          f"{' or '.join(map(str, kernels.MLP_HIDDEN_LAYERS))}")
    if n_feats_per_lvl not in kernels.HASHGRID_WIDTHS:
        errors.append(f"--pos_enc.n_feats_per_lvl {n_feats_per_lvl}: the CUDA hash-grid "
                      f"kernels take {', '.join(map(str, kernels.HASHGRID_WIDTHS))}")
    elif n_lvls * n_feats_per_lvl not in kernels.MLP_IN_DIMS:
        errors.append(f"--pos_enc.n_lvls {n_lvls} x --pos_enc.n_feats_per_lvl "
                      f"{n_feats_per_lvl} = {n_lvls * n_feats_per_lvl}: the CUDA MLP kernel "
                      f"takes encodings {' or '.join(map(str, kernels.MLP_IN_DIMS))} wide")
    if rgb_in_dims > max(kernels.MLP_IN_DIMS):
        errors.append(f"color head input {rgb_in_dims} wide (features plus SH basis): the CUDA "
                      f"MLP kernel takes inputs up to {max(kernels.MLP_IN_DIMS)} wide")
    if errors:
        raise ConfigError("network config outside what the CUDA kernels take (the CPU path "
                          "takes it): " + "; ".join(errors))


def check_kernel_config(net_cfg, device) -> None:
    """Raise ConfigError, naming each flag and its range, where a
    NetworkConfig asks for a network the CUDA kernels do not take, on a
    CUDA ``device``; any config on the CPU.  Entry points call it before
    they load data."""
    pe = net_cfg.pos_enc
    _check_kernel_shapes(
        device, density_hidden_dims=net_cfg.density_hidden_dims,
        density_hidden_layers=net_cfg.density_hidden_layers,
        rgb_hidden_dims=net_cfg.rgb_hidden_dims, rgb_hidden_layers=net_cfg.rgb_hidden_layers,
        n_lvls=pe.n_lvls, n_feats_per_lvl=pe.n_feats_per_lvl)


def check_field_spec(spec: "FieldSpec", device) -> None:
    """:func:`check_kernel_config` for a built field spec."""
    _check_kernel_shapes(
        device, density_hidden_dims=spec.density_hidden_dims,
        density_hidden_layers=spec.density_hidden_layers,
        rgb_hidden_dims=spec.rgb_hidden_dims, rgb_hidden_layers=spec.rgb_hidden_layers,
        n_lvls=spec.grid.num_levels, n_feats_per_lvl=spec.grid.level_dim,
        rgb_in_dims=spec.rgb_in_dims)


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
    """Spec of the ``style`` field kind (``use_dir``: color2 reads the view
    direction's SH basis too)."""
    return FieldSpec(grid=grid, class_dim=class_dim, use_dir=use_dir, kind="style", **kw)


def field_init(spec: FieldSpec, generator: torch.Generator, device=None) -> Params:
    """Initialize all parameters from ``generator`` (tables uniform ±1e-4,
    MLPs He-uniform), on ``device``."""
    enc = spec.grid.output_dim
    dh, dl = spec.density_hidden_dims, spec.density_hidden_layers
    rh, rl = spec.rgb_hidden_dims, spec.rgb_hidden_layers
    if spec.kind == "base":
        return {
            "x_embedder": hashgrid_init(spec.grid, generator, device),
            "density_net": mlp_init(generator, enc, dh, dl, spec.density_out_dims, device),
            "rgb_net": mlp_init(generator, spec.rgb_in_dims, rh, rl, 3, device),
        }
    return {
        "x_density_embedder": hashgrid_init(spec.grid, generator, device),
        "x_color_embedder": hashgrid_init(spec.grid, generator, device),
        "density_net": mlp_init(generator, enc, dh, dl, 1, device),
        "color1_net": mlp_init(generator, enc, dh, dl, 16, device),
        "color2_net": mlp_init(generator, spec.rgb_in_dims, rh, rl, 3, device),
        "class_net": mlp_init(generator, enc, dh, dl, spec.class_dim, device),
    }


def params_from_numpy(tree: Dict[str, object], device=None) -> Params:
    """JAX param tree (dict of numpy arrays / lists of arrays) -> port
    params; the kind is the one whose keys the tree holds (``x_embedder``:
    base)."""
    def conv(v):
        return torch.tensor(np.asarray(v), dtype=torch.float32, device=device)

    base = "x_embedder" in tree
    tables, mlps = (BASE_TABLE_KEYS, BASE_MLP_KEYS) if base else (TABLE_KEYS, MLP_KEYS)
    missing = set(tables + mlps) - set(tree)
    if missing:
        raise KeyError(f"param tree lacks {sorted(missing)}")
    params: Params = {k: conv(tree[k]) for k in tables}
    for k in mlps:
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


def _tree_to_tensors(tree: Any, device=None) -> Any:
    """A numpy tree (dicts, lists, tuples, NamedTuples) as tensors; an empty
    tuple (optax's MaskedNode) or None stays None."""
    if tree is None or (isinstance(tree, tuple) and len(tree) == 0):
        return None
    if isinstance(tree, dict):
        return {k: _tree_to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to_tensors(v, device) for v in tree]
    if isinstance(tree, tuple):
        items = [_tree_to_tensors(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return torch.from_numpy(np.array(tree)).to(device)


def _tree_to_numpy(tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to_numpy(v) for v in tree]
    if isinstance(tree, tuple):
        items = [_tree_to_numpy(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree.detach().cpu().numpy()


def train_state_from_numpy(
    params: Dict[str, object], opt_state: Any, ema_state: Any, device=None
) -> Tuple[Params, OptState, EmaState]:
    """The JAX trainer's ``params``, ``opt_state`` (optax's apply_if_finite
    over masked adam) and ``ema_state`` as numpy trees -> the port's
    (params, :class:`OptState`, :class:`EmaState`).  Reads the optax state by
    attribute (``notfinite_count``, ``inner_state``, ...), so it needs no
    optax; a masked-out moment (optax's empty MaskedNode) becomes None."""
    p = params_from_numpy(params, device)
    opt = opt_state_from_tree(_tree_to_tensors(opt_state, device))
    ema = EmaState(shadow=params_from_numpy(ema_state.shadow, device),
                   num_updates=torch.from_numpy(np.array(ema_state.num_updates)))
    return p, opt, ema


def train_state_to_numpy(params: Params, opt_state: OptState, ema_state: EmaState):
    """The port's train state -> (params, opt_state, ema_state) numpy trees
    whose leaves, flattened in JAX order (dict keys sorted, None holding no
    leaf), are the JAX trainer's leaves."""
    return params_to_numpy(params), _tree_to_numpy(opt_state), _tree_to_numpy(ema_state)


def _encoder_input(bbox: BBox, pts: torch.Tensor) -> torch.Tensor:
    """bbox-normalize to [0, 1], then the reference's (x + 1) / 2."""
    return (bbox.normalize(pts) + 1.0) / 2.0


def _view_head(spec: FieldSpec, weights: List[torch.Tensor], feat: torch.Tensor,
               dirs: Optional[torch.Tensor], compute_dtype: torch.dtype,
               plain: bool) -> torch.Tensor:
    """The last color MLP on ``feat`` [M, k] and the SH basis of the
    directions [M, 3], as the field reads it (``sh_encode((dirs + 1) /
    2)``): one input [M, width] padded with zeros to the width K5 takes
    (:func:`~nerfstyle_torch.ops.sh.sh_assemble`), and the first weight
    matrix with zero rows to match -> sigmoid rgb [M, 3]."""
    if dirs is None:
        raise ValueError(f"the {spec.kind} field{' with use_dir' if spec.use_dir else ''} "
                         "reads the view directions: pass dirs")
    width = kernel_in_width(spec.rgb_in_dims)
    x = sh_assemble(feat, dirs, spec.sh_degree, width, plain=plain)
    return mlp_apply(pad_weights(weights, width), x, output_activation="sigmoid",
                     compute_dtype=compute_dtype, plain=plain)


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
    table = params["x_density_embedder" if spec.kind == "style" else "x_embedder"]
    h = hashgrid_encode(spec.grid, table, x, plain=plain)
    out = mlp_apply(params["density_net"], h, compute_dtype=compute_dtype, plain=plain)
    return trunc_exp(out[:, 0] + spec.density_offset)


def field_color(
    spec: FieldSpec,
    params: Params,
    bbox: BBox,
    pts: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    *,
    dirs: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Color-branch-only forward: [M, 3] world points (and [M, 3] view
    directions where the spec reads them) -> [M, out_channels] channels
    (sigmoid rgb, then the style kind's raw class logits).  The base kind's
    color head reads the density MLP's features: there it is
    :func:`field_apply`'s channels, as in JAX."""
    if spec.kind != "style":
        rgbs, _ = field_apply(spec, params, bbox, pts, compute_dtype, dirs=dirs, plain=plain)
        return rgbs
    x = _encoder_input(bbox, pts)
    h = hashgrid_encode(spec.grid, params["x_color_embedder"], x, plain=plain)
    return _color_heads(spec, params, h, dirs, compute_dtype, plain)


def _color_heads(spec: FieldSpec, params: Params, h_color: torch.Tensor,
                 dirs: Optional[torch.Tensor], compute_dtype: torch.dtype,
                 plain: bool) -> torch.Tensor:
    """The class, color1 and color2 heads (three K5 launches on CUDA, and
    K5d under ``use_dir``)."""
    classes = mlp_apply(params["class_net"], h_color, compute_dtype=compute_dtype, plain=plain)
    color1 = mlp_apply(params["color1_net"], h_color, compute_dtype=compute_dtype, plain=plain)
    if spec.use_dir:
        rgb = _view_head(spec, params["color2_net"], color1, dirs, compute_dtype, plain)
    else:
        rgb = mlp_apply(params["color2_net"], color1, output_activation="sigmoid",
                        compute_dtype=compute_dtype, plain=plain)
    return torch.cat([rgb, classes], dim=-1)


def field_apply(
    spec: FieldSpec,
    params: Params,
    bbox: BBox,
    pts: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    *,
    dirs: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: [M, 3] world points (and [M, 3] view directions where
    the spec reads them) -> (channels [M, out_channels], sigmas [M]).

    Style kind: the density and color tables share their corners, so one
    encode of the concatenated [T, 2C] table serves both (as in JAX); its
    table gradient splits back into the two tables through the concat.
    Where 2C is wider than K1's rows (C = 4) each table is encoded on its
    own: the same features.  Base kind: one encode, the density MLP, and
    ``rgb_net`` on its outputs 1.. and the directions' SH basis."""
    x = _encoder_input(bbox, pts)
    if spec.kind == "base":
        h = hashgrid_encode(spec.grid, params["x_embedder"], x, plain=plain)
        out = mlp_apply(params["density_net"], h, compute_dtype=compute_dtype, plain=plain)
        sigmas = trunc_exp(out[:, 0] + spec.density_offset)
        return _view_head(spec, params["rgb_net"], out[:, 1:], dirs, compute_dtype,
                          plain), sigmas
    c = spec.grid.level_dim
    if 2 * c in kernels.HASHGRID_WIDTHS:
        fused = torch.cat([params["x_density_embedder"], params["x_color_embedder"]], dim=1)
        h = hashgrid_encode(spec.grid, fused, x, plain=plain)
        h = h.reshape(-1, spec.grid.num_levels, 2 * c)
        h_density = h[..., :c].reshape(-1, spec.grid.output_dim)
        h_color = h[..., c:].reshape(-1, spec.grid.output_dim)
    else:
        h_density = hashgrid_encode(spec.grid, params["x_density_embedder"], x, plain=plain)
        h_color = hashgrid_encode(spec.grid, params["x_color_embedder"], x, plain=plain)
    out = mlp_apply(params["density_net"], h_density, compute_dtype=compute_dtype, plain=plain)
    sigmas = trunc_exp(out[:, 0] + spec.density_offset)
    return _color_heads(spec, params, h_color, dirs, compute_dtype, plain), sigmas
