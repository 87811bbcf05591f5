"""Hash-grid neural field, ``style`` kind (counterpart of
``nerfstyle_tpu/models/fields.py``).

Parameters are a plain dict under the JAX keys: two hash tables
``x_density_embedder`` and ``x_color_embedder`` ([T, C] each) and four
bias-free MLPs ``density_net``, ``color1_net``, ``color2_net``,
``class_net`` (lists of [d_in, d_out] matrices).  :func:`params_from_numpy`
and :func:`params_to_numpy` carry weights between the JAX package's numpy
trees and the port's tensors.

Every MLP goes through :func:`~nerfstyle_torch.ops.mlp.mlp_apply` (kernel K5
on CUDA tensors).  Rendering reads the field in two halves: :func:`field_density` (density
table + density MLP) and :func:`field_color` (color table + class, color1
and color2 heads); a train step's phase B reads it whole with
:func:`field_apply`, one encode of the concatenated ``[T, 4]`` tables.  All
three are differentiable in the params.  The view-direction (SH) input and
the ``base`` field kind are not ported yet.  The encoder sees
``(normalize(x) + 1) / 2``, the reference's quirk.

:func:`train_state_from_numpy` and :func:`train_state_to_numpy` carry a
trainer's params, optimizer state and EMA between the JAX package's numpy
trees and the port's tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from .. import kernels
from ..config import ConfigError
from ..core.types import BBox
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, hashgrid_init, hashgrid_spec
from ..ops.mlp import mlp_apply, mlp_init, trunc_exp
from ..training.ema import EmaState
from ..training.optim import OptState, opt_state_from_tree

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


def _check_kernel_shapes(device, *, density_hidden_dims: int, density_hidden_layers: int,
                         rgb_hidden_dims: int, rgb_hidden_layers: int, n_lvls: int,
                         n_feats_per_lvl: int) -> None:
    """On a CUDA device, raise ConfigError listing each network flag whose
    value the CUDA kernels do not take, with the range it may take: K5's
    hidden width, hidden depths and input widths (csrc/mlp.cu), K1/K2's
    table row widths (csrc/hashgrid.cu).  The CPU path takes any value."""
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
        n_lvls=spec.grid.num_levels, n_feats_per_lvl=spec.grid.level_dim)


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
    out = mlp_apply(params["density_net"], h, compute_dtype=compute_dtype, plain=plain)
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
    return _color_heads(params, h, compute_dtype, plain)


def _color_heads(params: Params, h_color: torch.Tensor, compute_dtype: torch.dtype,
                 plain: bool) -> torch.Tensor:
    """The class, color1 and color2 heads (three K5 launches on CUDA)."""
    classes = mlp_apply(params["class_net"], h_color, compute_dtype=compute_dtype, plain=plain)
    color1 = mlp_apply(params["color1_net"], h_color, compute_dtype=compute_dtype, plain=plain)
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
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: [M, 3] world points -> (channels [M, 3 + class_dim],
    sigmas [M]).  The density and color tables share their corners, so one
    encode of the concatenated [T, 2C] table serves both (as in JAX); its
    table gradient splits back into the two tables through the concat.
    Where 2C is wider than K1's rows (C = 4) each table is encoded on its
    own: the same features."""
    x = _encoder_input(bbox, pts)
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
    return _color_heads(params, h_color, compute_dtype, plain), sigmas
