"""Configuration schemas, as far as rendering from a checkpoint needs them.

The JAX package writes every config into a checkpoint's ``meta`` with
``Config.asdict()`` (``nerfstyle_tpu/config.py``).  This module holds the
port's own copy of those dataclasses, field for field, and the strict
``_from_dict`` that reads them back, so that ``python -m
nerfstyle_torch.render`` reads the same ``meta`` the way the JAX
``render.py`` does.  The YAML layering and CLI generation of the JAX module
belong to training and are not here.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, Optional


class ConfigError(ValueError):
    pass


def _strip_optional(tp):
    if typing.get_origin(tp) is typing.Union and type(None) in typing.get_args(tp):
        return next(a for a in typing.get_args(tp) if a is not type(None))
    return tp


def _convert(value: Any, tp, key: str) -> Any:
    """Strictly convert a raw JSON/YAML value to the annotated field type."""
    if value is None:
        return None
    tp = _strip_optional(tp)
    if dataclasses.is_dataclass(tp):
        if not isinstance(value, dict):
            raise ConfigError(f'field "{key}" expects a mapping, got {value!r}')
        return _from_dict(tp, value, prefix=key + ".")
    if tp is Path:
        return Path(str(value)).expanduser()
    if tp is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f'field "{key}" expects a bool, got {value!r}')
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f'field "{key}" expects an int, got {value!r}')
        return int(value)
    if tp is float:
        if not isinstance(value, (int, float)):
            raise ConfigError(f'field "{key}" expects a number, got {value!r}')
        return float(value)
    if tp is str:
        return str(value)
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        (elem_tp,) = typing.get_args(tp)[:1] or (str,)
        seq = [_convert(v, elem_tp, f"{key}[{i}]") for i, v in enumerate(value)]
        return tuple(seq) if origin is tuple else seq
    if isinstance(tp, type) and issubclass(tp, Enum):
        return value if isinstance(value, tp) else tp[str(value).upper()]
    return value


def _from_dict(cls, data: Dict[str, Any], prefix: str = ""):
    """Strict dict -> dataclass: unknown keys raise, missing required fields
    raise."""
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(field_map)
    if unknown:
        raise ConfigError(
            f"Unrecognized parameters while parsing {cls.__name__}: "
            + ", ".join(sorted(prefix + u for u in unknown))
        )
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, f in field_map.items():
        if name in data:
            kwargs[name] = _convert(data[name], hints.get(name, f.type), prefix + name)
        elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
            raise ConfigError(f'missing required config field "{prefix}{name}" for {cls.__name__}')
    return cls(**kwargs)


@dataclass
class Config:
    def asdict(self) -> Dict[str, Any]:
        def enc(v):
            if isinstance(v, Path):
                return str(v)
            if isinstance(v, Enum):
                return v.name
            if isinstance(v, tuple):
                return list(v)
            return v

        return {k: enc(v) for k, v in dataclasses.asdict(self).items()}


@dataclass
class ReplicaConfig(Config):
    name: str = ""
    focal_ratio: float = 1.0
    traj_ids: List[int] = field(default_factory=list)
    black2white: bool = False


@dataclass
class DatasetConfig(Config):
    root_path: Path = Path(".")
    type: str = "LLFF"
    bound: float = 1.0
    scale: float = 1.0
    ct_image: Optional[Path] = None
    seg_name: str = "seg"
    replica_cfg: Optional[ReplicaConfig] = None


@dataclass
class HashGridConfig(Config):
    n_lvls: int = 16
    n_feats_per_lvl: int = 2
    hashmap_size: int = 19
    min_res: int = 16
    max_res_coeff: float = 1024
    simplex_from: int = -1
    """First simplex-interpolated level; -1 = all trilinear.  The port
    encodes trilinear levels only (see ops/hashgrid.py)."""


@dataclass
class NetworkConfig(Config):
    network_seed: Optional[int] = 80000
    density_out_dims: int = 16
    density_hidden_dims: int = 64
    density_hidden_layers: int = 1
    rgb_hidden_dims: int = 64
    rgb_hidden_layers: int = 2
    pos_enc: HashGridConfig = field(default_factory=HashGridConfig)
    dir_enc_sh_deg: int = 4
    density_offset: float = 0.0


@dataclass
class RendererConfig(Config):
    grid_size: int = 128
    grid_bsize: Optional[int] = None
    update_iter: int = 16
    min_near: float = 0.2
    t_thresh: float = 1e-4
    use_ndc: bool = False
    flip_camera: int = 0
    max_steps: int = 1024
    update_thres: int = 256
    density_scale: float = 1.0
    density_thresh: float = 10.0
    density_decay: float = 0.95
    max_samples_per_ray: int = 256
    max_budget_samples: int = 1_048_576
    window_init_bucket: int = 0


@dataclass
class TrainIntervalConfig(Config):
    print: int = 100
    log: int = 100
    ckpt: int = 5000
    test: int = 1000


@dataclass
class TrainConfig(Config):
    num_rays_per_batch: int = 4096
    profile_dir: Optional[Path] = None
    profile_start: int = 8
    profile_steps: int = 8
    defer_patch_size: int = 200
    precrop_iterations: int = 0
    precrop_fraction: float = 0.5
    initial_learning_rate: float = 0.01
    learning_rate_decay: int = 30000
    max_eval_count: Optional[int] = 20
    num_iterations: int = 15000
    test_before_train: bool = False
    intervals: TrainIntervalConfig = field(default_factory=TrainIntervalConfig)
    rng_seed: int = 69420
    enable_amp: bool = True
    """Mixed precision: bf16 matmul inputs with fp32 accumulation."""
    ema_decay: Optional[float] = 0.95
    adaptive_batch: bool = False
    adaptive_batch_max_rays: int = 32768
    adaptive_batch_budget: int = 0
    two_phase_train: bool = True
    two_phase_init_bucket: int = 0
    sparsity_lambda: float = 0.0
    sparsity_exp_coeff: float = 0.05
    sparsity_samples: int = 50000
    weight_reg_lambda: float = 0.0
    class_lambda: float = 0.001
    content_lambda: float = 0.025
    style_lambda: float = 0.1
    photo_lambda: float = 0.0001
    style_geom_cache: bool = True
    style_step_window_slots: int = 524288
    style_geom_cache_max_poses: int = 0
    style_geom_cache_bytes: float = 4e9
    style_geom_cache_eps: float = 1e-4
    style_seg_path: Optional[Path] = None
    style_matching: Optional[str] = None
