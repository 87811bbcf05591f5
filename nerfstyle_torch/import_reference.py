"""Import a reference ``iter_*.pth`` checkpoint into a ``.ckpt`` of this
repository (the port's counterpart of ``tools/import_reference_ckpt.py``)::

    python -m nerfstyle_torch.import_reference iter_060000.pth --out imported.ckpt \\
        [--mlp-npz heads.npz] [--root-path /data/llff/room] [--device cpu]

The reference trainer saves a torch pickle of config objects and state
dicts, of which ``renderer`` holds what rendering needs: the model tensors,
the Morton-ordered occupancy ``density_grid`` and packed
``density_bitfield``, and the marching statistics.  The import:

* loads the pickle without the reference package: a class that cannot be
  imported (its config dataclasses) comes back as an attribute bag;
* keeps the fields of each reference config that this repository's config
  classes have;
* copies the hash-grid tables (``x_density_embedder.embeddings``,
  ``x_color_embedder.embeddings``: the same ``[rows, level_dim]`` layout,
  level offsets and index laws, so rows align one to one);
* takes the MLP heads from ``--mlp-npz`` (layer-wise ``<net>.<i>``
  matrices of shape ``[d_in, d_out]``) or initializes them afresh (the
  reference's tiny-cuda-nn blobs are not convertible);
* converts the occupancy state from Morton to linear order and unpacks the
  bitfield on the device (kernels K8a, K8b; ``interop.py``);
* writes the ``.npz`` checkpoint with ``params``, ``occ`` (the five
  persisted leaves) and ``ema`` initialised from the params, as the JAX tool
  does.  It renders with ``python -m nerfstyle_torch.render`` and seeds the
  style stage; there is no optimizer state to convert.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import resolve_device, utils
from .config import DatasetConfig, NetworkConfig, RendererConfig, TrainConfig, _from_dict
from .interop import import_reference_grid_state
from .models.fields import field_init, make_grid_spec, style_field_spec
from .ops.occupancy import PersistedOccupancy
from .training import checkpoint as ckpt_lib
from .training.ema import ema_init

logger = utils.create_logger("import_reference")

HEADS = ("density_net", "color1_net", "color2_net", "class_net")


class _Stub:
    """Attribute bag standing in for a pickled class that cannot be imported."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["__state__"] = state


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


class _PickleShim:
    """``pickle_module`` for ``torch.load`` with the tolerant unpickler."""

    Unpickler = _TolerantUnpickler

    @staticmethod
    def load(f, **kw):
        return _TolerantUnpickler(f, **kw).load()


def load_reference_ckpt(path: Path):
    """The reference checkpoint's pickled dict, its tensors on the CPU.  It
    unpickles arbitrary objects: load only files of a trusted reference run."""
    return torch.load(path, map_location="cpu", pickle_module=_PickleShim, weights_only=False)


def _plain(obj):
    """Config objects (or their stubs) as JSON-able values."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if isinstance(obj, Path):
        return str(obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, (int, float, str, bool, type(None))):
        return {k: _plain(v) for k, v in obj.__dict__.items() if not k.startswith("_")}
    return obj


def _cfg_dict(ref_cfg, target_cls) -> Dict:
    """The fields of a reference config object that ``target_cls`` has."""
    plain = _plain(ref_cfg) or {}
    ours = {f.name for f in dataclasses.fields(target_cls)}
    return {k: v for k, v in plain.items() if k in ours}


def _load_heads(path: Path, params: Dict) -> List[str]:
    """Replace the heads that ``path`` holds (``<net>.<i>``); returns their
    names."""
    loaded = []
    with np.load(path) as z:
        for net in HEADS:
            keys = sorted((k for k in z.files if k.startswith(net + ".")),
                          key=lambda k: int(k.split(".")[1]))
            if not keys:
                continue
            mats = [torch.from_numpy(np.asarray(z[k], np.float32)) for k in keys]
            have = [tuple(w.shape) for w in params[net]]
            got = [tuple(m.shape) for m in mats]
            if have != got:
                raise SystemExit(f"{net}: npz shapes {got} != expected {have}")
            params[net] = mats
            loaded.append(net)
    return loaded


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Convert ``argv``'s reference checkpoint; returns the written path."""
    ap = argparse.ArgumentParser(prog="python -m nerfstyle_torch.import_reference",
                                 description="Import a reference iter_*.pth checkpoint.")
    ap.add_argument("pth", type=Path, help="reference iter_*.pth checkpoint")
    ap.add_argument("--out", type=Path, required=True, help="output .ckpt path")
    ap.add_argument("--mlp-npz", type=Path, default=None,
                    help="layer-wise MLP head export (<net>.<i> arrays)")
    ap.add_argument("--root-path", type=Path, default=None,
                    help="override the dataset root recorded in the checkpoint")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    sd = load_reference_ckpt(args.pth)
    ren = sd["renderer"]
    model = ren["model"]
    net_d = _cfg_dict(sd.get("net_cfg"), NetworkConfig)
    train_d = _cfg_dict(sd.get("train_cfg"), TrainConfig)
    render_d = _cfg_dict(sd.get("render_cfg"), RendererConfig)
    data_d = _cfg_dict(sd.get("dataset_cfg"), DatasetConfig)
    if args.root_path is not None:
        data_d["root_path"] = str(args.root_path)
    net_cfg = _from_dict(NetworkConfig, net_d)
    render_cfg = _from_dict(RendererConfig, render_d)

    # The reference takes max_bound from the dataset's box; ``bound`` is the
    # marching cube's half-extent, the same for the box-from-radius datasets.
    bound = float(ren["bound"])
    pe = net_cfg.pos_enc
    grid_spec = make_grid_spec(n_lvls=pe.n_lvls, n_feats_per_lvl=pe.n_feats_per_lvl,
                               hashmap_size=pe.hashmap_size, min_res=pe.min_res,
                               max_res_coeff=pe.max_res_coeff, max_bound=2.0 * bound)
    # class_dim is not recoverable from the packed class head; the renderer
    # records raymarch_channels = 3 + class_dim.
    class_dim = max(0, int(ren.get("raymarch_channels", 3)) - 3)
    spec = style_field_spec(
        grid_spec, class_dim=class_dim, density_hidden_dims=net_cfg.density_hidden_dims,
        density_hidden_layers=net_cfg.density_hidden_layers,
        rgb_hidden_dims=net_cfg.rgb_hidden_dims, rgb_hidden_layers=net_cfg.rgb_hidden_layers,
        density_offset=net_cfg.density_offset,
    )
    params = field_init(spec, torch.Generator().manual_seed(net_cfg.network_seed or 0))
    want = tuple(params["x_density_embedder"].shape)
    for name in ("x_density_embedder", "x_color_embedder"):
        emb = model[f"{name}.embeddings"].detach().to(torch.float32).contiguous()
        if tuple(emb.shape) != want:
            raise SystemExit(f"{name}: reference table shape {tuple(emb.shape)} != {want}: "
                             "pos_enc config mismatch (hashmap_size, n_lvls, min_res, "
                             "max_res_coeff, bound)")
        params[name] = emb
    heads = _load_heads(args.mlp_npz, params) if args.mlp_npz is not None else []

    grid_size = int(render_cfg.grid_size)
    density, bits = import_reference_grid_state(
        np.asarray(ren["density_grid"], np.float32), np.asarray(ren["density_bitfield"], np.uint8),
        grid_size, dev)
    occ = PersistedOccupancy(
        density_grid=density, bitfield=bits,
        mean_density=torch.tensor(float(ren.get("mean_density", 0.0)), dtype=torch.float32),
        mean_count=torch.tensor(int(ren.get("mean_count", 0)), dtype=torch.int32),
        local_step=torch.tensor(int(ren.get("local_step", 0)), dtype=torch.int32),
    )
    meta = {
        "version": _plain(sd.get("version", "imported")),
        "log_dir": str(args.out.parent),
        "iter_ctr": int(sd.get("iter_ctr", 0)),
        "cfg": _plain(sd.get("cfg")) or {},
        "dataset_cfg": data_d,
        "train_cfg": train_d,
        "net_cfg": net_d,
        "render_cfg": render_d,
        "imported_from": str(args.pth),
        "imported_mlp_heads": heads,
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    ckpt_lib.save_checkpoint(args.out, meta,
                             {"params": params, "occ": occ, "ema": ema_init(params)})
    fresh = [n for n in HEADS if n not in heads]
    logger.info("Wrote %s: grid tables %d rows x %d; occupancy grid %d, %d occupied cells",
                args.out, want[0], want[1], grid_size, int(bits.sum()))
    if heads:
        logger.info("MLP heads imported from %s: %s", args.mlp_npz, heads)
    if fresh:
        logger.info("MLP heads freshly initialized (not convertible): %s", fresh)
    return args.out


if __name__ == "__main__":
    main()
