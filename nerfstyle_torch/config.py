"""Configuration schemas and the layered YAML + CLI loader (counterpart of
``nerfstyle_tpu/config.py``).

The dataclasses are the port's own copy of the JAX package's, field for
field, so that a checkpoint's ``meta`` (written with ``Config.asdict()``)
reads back in either package.  The loader follows the same layering and flag
rules::

    dataclass defaults <- default YAML (cfgs/...) <- task YAML <- CLI flags

Every (nested) field is a flag (``--num_rays_per_batch`` or
``--num-rays-per-batch``, ``--intervals.print``); a bool flag toggles its
loaded default (``--enable_amp`` turns the default True off); leftover flags
chain from one config group to the next and must end empty.  The YAML files
of ``cfgs/`` are read by :func:`read_yaml`, a reader of the subset they use
(nested mappings, scalars, comments), so the port needs no YAML package.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple, Type, TypeVar

# The repository's config files; default paths below are relative to it.
CFGS_ROOT = Path(__file__).resolve().parent.parent

T = TypeVar("T", bound="Config")


class ConfigError(ValueError):
    pass


class ConfigValue(Enum):
    """A flag passed with no argument (``--ckpt`` alone)."""

    EmptyPassed = "__empty__"


def flatten(d: Dict[str, Any], delim: str = ".") -> Dict[str, Any]:
    items: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, dict):
            for sk, sv in flatten(v, delim).items():
                items[k + delim + sk] = sv
        else:
            items[k] = v
    return items


def unflatten(d: Dict[str, Any], delim: str = ".") -> Dict[str, Any]:
    items: Dict[str, Any] = {}
    for k, v in d.items():
        parts = k.split(delim)
        cur = items
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return items


def _yaml_scalar(text: str) -> Any:
    t = text.strip()
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in ("true", "True", "TRUE"):
        return True
    if t in ("false", "False", "FALSE"):
        return False
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_yaml_scalar(v) for v in inner.split(",")] if inner else []
    for conv in (int, float):
        try:
            return conv(t)
        except ValueError:
            pass
    return t


def read_yaml(path: Path) -> Dict[str, Any]:
    """Read a YAML file of nested mappings with scalar (or ``[a, b]``)
    values, the subset the repository's ``cfgs/*.yaml`` use; anything else
    raises :class:`ConfigError`."""
    root: Dict[str, Any] = {}
    stack: List[Tuple[int, Dict[str, Any]]] = [(-1, root)]
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.split(" #", 1)[0].rstrip() if not raw.lstrip().startswith("#") else ""
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep or not key or key.startswith("- "):
            raise ConfigError(f"{path}:{lineno}: unsupported YAML line {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if rest.strip():
            parent[key] = _yaml_scalar(rest)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
    # A key with nothing under it is null, as in YAML.
    def fix(d):
        return {k: (None if v == {} else fix(v) if isinstance(v, dict) else v) for k, v in d.items()}

    return fix(root)


def _strip_optional(tp):
    if typing.get_origin(tp) is typing.Union and type(None) in typing.get_args(tp):
        return next(a for a in typing.get_args(tp) if a is not type(None))
    return tp


def _convert(value: Any, tp, key: str) -> Any:
    """Strictly convert a raw JSON/YAML value to the annotated field type."""
    if value is None:
        return None
    if value is ConfigValue.EmptyPassed:
        return value
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
    """Base of every config group: the layered load and the CLI parser."""

    default_path: ClassVar[Optional[str]] = None

    @classmethod
    def read_nargs(cls: Type[T], argv: Optional[Sequence[str]] = None) -> Tuple[T, List[str]]:
        """Parse this config from ``argv`` (default ``sys.argv[1:]``); returns
        it and the flags it did not consume."""
        args, nargs = cls.create_parser().parse_known_args(argv)
        return _from_dict(cls, {k: v for k, v in vars(args).items() if v is not None}), nargs

    @classmethod
    def load_nargs(
        cls: Type[T], config_path: Optional[Path] = None, nargs: Sequence[str] = ()
    ) -> Tuple[T, List[str]]:
        """Layered load: default YAML <- ``config_path`` YAML <- the flags of
        ``nargs`` this group knows; returns it and the leftover flags."""
        if cls.default_path is None and config_path is None:
            raise ConfigError(f"{cls.__name__} has no default config file; give one")
        cfg_dict: Dict[str, Any] = {}
        if cls.default_path is not None:
            cfg_dict = read_yaml(CFGS_ROOT / cls.default_path)
        if config_path is not None:
            cfg_dict.update(read_yaml(Path(config_path)))
        rest = list(nargs)
        if rest:
            args, rest = cls.create_parser(flatten(cfg_dict)).parse_known_args(rest)
            cfg_dict = unflatten(dict(vars(args)))
        return _from_dict(cls, cfg_dict), rest

    @classmethod
    def load(cls: Type[T], config_path: Optional[Path] = None) -> T:
        return cls.load_nargs(config_path)[0]

    @classmethod
    def create_parser(cls, loaded_values: Optional[Dict[str, Any]] = None) -> argparse.ArgumentParser:
        """One flag per (nested) field, defaulting to the loaded value: a bool
        toggles it, an enum takes its lowercase names, a list takes many."""
        parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)

        def argnames(k: str) -> List[str]:
            return ["--" + k] + (["--" + k.replace("_", "-")] if "_" in k else [])

        def add_fields(c, prefix: str) -> None:
            hints = typing.get_type_hints(c)
            for f in dataclasses.fields(c):
                tp = _strip_optional(hints.get(f.name, f.type))
                key = prefix + f.name
                if dataclasses.is_dataclass(tp):
                    add_fields(tp, key + ".")
                    continue
                if loaded_values is not None and key in loaded_values:
                    default = loaded_values[key]
                elif f.default is not dataclasses.MISSING:
                    default = f.default
                elif f.default_factory is not dataclasses.MISSING:
                    default = f.default_factory()
                else:
                    default = None
                if default is None:
                    base = tp
                    if tp is Path or (isinstance(tp, type) and issubclass(tp, Enum)) or \
                            typing.get_origin(tp) in (list, tuple):
                        base = str
                    parser.add_argument(*argnames(key), type=base, nargs="?", default=None,
                                        const=ConfigValue.EmptyPassed, dest=key)
                elif isinstance(default, bool):
                    parser.add_argument(*argnames(key), default=default, dest=key,
                                        action="store_false" if default else "store_true")
                elif isinstance(default, Enum):
                    parser.add_argument(*argnames(key), default=default.name.lower(), dest=key,
                                        choices=[n.lower() for n in type(default).__members__])
                elif isinstance(default, (list, tuple)):
                    parser.add_argument(*argnames(key), nargs="*", default=list(default), dest=key,
                                        type=type(default[0]) if default else str)
                else:
                    # The annotation, not the default, sets the type: a YAML
                    # layer may give 10 for a float field.
                    base = tp if tp in (int, float, str) else (str if tp is Path else type(default))
                    parser.add_argument(*argnames(key), type=base, default=default, dest=key)

        add_fields(cls, "")
        return parser

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

    default_path = "cfgs/dataset/default.yaml"


@dataclass
class HashGridConfig(Config):
    n_lvls: int = 16
    n_feats_per_lvl: int = 2
    hashmap_size: int = 19
    min_res: int = 16
    max_res_coeff: float = 1024
    simplex_from: int = -1
    """First simplex-interpolated level (4 Freudenthal vertices instead of
    8 trilinear corners; see ops/hashgrid.py); -1 = all trilinear."""


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

    default_path = "cfgs/network/default.yaml"


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

    default_path = "cfgs/renderer/default.yaml"


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
    """Style stage: cache each pose's frozen geometry (its weight-significant
    samples) once and run every iteration over the cache.  False (the
    reference's two-pass scheme) is not ported yet and raises."""
    style_step_window_slots: int = 524288
    """A TPU memory bound of the JAX style step (it windows the stream to cap
    its sort temporaries).  The port's table gradient uses atomics and has no
    such temporaries: accepted for checkpoint and CLI parity, not read."""
    style_geom_cache_max_poses: int = 0
    """Most pose caches held at once (least recently used evicted); 0: no
    bound."""
    style_geom_cache_bytes: float = 4e9
    """Most bytes of pose caches held at once; 0: no bound."""
    style_geom_cache_eps: float = 1e-4
    """Weight threshold of the pose cache: samples with w <= eps are dropped
    (at most eps times the samples of a ray, logged per pose)."""
    style_seg_path: Optional[Path] = None
    """Style image segment map (.npz with ``seg_map``)."""
    style_matching: Optional[str] = None
    """A given class-to-cluster matching ("2,0,1"), in place of the
    Hungarian one."""

    default_path = "cfgs/training/default.yaml"


@dataclass
class BaseConfig(Config):
    """The flags of the train entry point itself."""

    log_dir: Optional[Path] = None
    data_cfg: Optional[Path] = None
    ckpt: Optional[Path] = None
    style_image: Optional[Path] = None
    yes: bool = False
    """Assume yes for confirmation prompts (cleaning a non-empty log dir)."""
