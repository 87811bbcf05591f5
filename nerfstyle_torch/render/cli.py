"""Novel-view rendering from a checkpoint (the port's ``render.py``).

Every config is read from the checkpoint, which may come from either
package; ``--out-dims W H`` re-renders at a scaled resolution and
``--max-count`` caps the number of test frames.  Runs on ``cuda`` unless
``--device cpu`` is given::

    python -m nerfstyle_torch.render logs/room/iter_15000.ckpt --out-dims 1008 756

Under ``torchrun --nproc_per_node N -m nerfstyle_torch.render ...`` each
rank renders its slice of every chunk's rays on ``cuda:LOCAL_RANK`` (or the
CPU with ``--device cpu``), every rank holds the gathered frame and rank 0
writes it (:mod:`nerfstyle_torch.parallel`; ``--dist-backend`` as for
training).
"""

from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device, utils
from ..config import DatasetConfig, NetworkConfig, RendererConfig, TrainConfig, _from_dict
from ..core.types import DatasetSplit
from ..data import get_dataset
from ..data.base import BaseDataset
from ..models.fields import FieldSpec, Params, check_kernel_config, make_grid_spec, style_field_spec
from ..ops.occupancy import occupancy_init, occupancy_persistable
from ..parallel.mesh import BACKENDS, Mesh, active, init_from_env
from ..training import checkpoint as ckpt_lib
from .renderer import Renderer, RenderSettings

logger = utils.create_logger("render")


def param_template(spec: FieldSpec) -> Dict[str, object]:
    """Structure of a field's param tree (one placeholder per leaf)."""
    n_density = spec.density_hidden_layers + 1
    return {
        "x_density_embedder": 0,
        "x_color_embedder": 0,
        "density_net": [0] * n_density,
        "color1_net": [0] * n_density,
        "class_net": [0] * n_density,
        "color2_net": [0] * (spec.rgb_hidden_layers + 1),
    }


def _check_params(spec: FieldSpec, params: Params) -> None:
    """Shapes and dtype of restored params against the spec."""
    for w in [params[k] for k in ("x_density_embedder", "x_color_embedder")] + [
        w for k in ("density_net", "color1_net", "class_net", "color2_net") for w in params[k]
    ]:
        if w.dtype != torch.float32:
            raise ValueError(f"checkpoint params must be float32, got {w.dtype}")
    want_table = (spec.grid.total_params, spec.grid.level_dim)
    for k in ("x_density_embedder", "x_color_embedder"):
        if tuple(params[k].shape) != want_table:
            raise ValueError(f"{k}: checkpoint shape {tuple(params[k].shape)} != {want_table}")
    enc, dh = spec.grid.output_dim, spec.density_hidden_dims
    heads = {
        "density_net": [enc] + [dh] * spec.density_hidden_layers + [1],
        "color1_net": [enc] + [dh] * spec.density_hidden_layers + [16],
        "class_net": [enc] + [dh] * spec.density_hidden_layers + [spec.class_dim],
        "color2_net": [16] + [spec.rgb_hidden_dims] * spec.rgb_hidden_layers + [3],
    }
    for k, dims in heads.items():
        got = [tuple(w.shape) for w in params[k]]
        want = list(zip(dims[:-1], dims[1:]))
        if got != want:
            raise ValueError(f"{k}: checkpoint shapes {got} != {want}")


def load_renderer(
    ckpt_path: Path,
    device: DeviceLike = None,
    out_dims: Optional[Tuple[int, int]] = None,
    max_count: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[Renderer, Params, BaseDataset, Dict]:
    """Build the renderer, params and test split a checkpoint describes
    (the renderer sharded over ``mesh`` where it has several ranks)."""
    dev = resolve_device(device)
    meta, groups = ckpt_lib.load_checkpoint(ckpt_path)
    dataset_cfg = _from_dict(DatasetConfig, meta["dataset_cfg"])
    net_cfg = _from_dict(NetworkConfig, meta["net_cfg"])
    render_cfg = _from_dict(RendererConfig, meta["render_cfg"])
    train_cfg = _from_dict(TrainConfig, meta["train_cfg"])
    check_kernel_config(net_cfg, dev)

    # Train split only for the class count, then the test poses (rank 0
    # first: a generated scene is written on its first load).
    mesh = active(mesh)
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
    train_set = get_dataset(dataset_cfg, split=DatasetSplit.TRAIN)
    test_set = get_dataset(dataset_cfg, split=DatasetSplit.TEST, max_count=max_count)
    if mesh is not None and mesh.is_main:
        mesh.barrier()
    max_bound = float(train_set.bbox.size.max())
    pe = net_cfg.pos_enc
    grid_spec = make_grid_spec(
        n_lvls=pe.n_lvls, n_feats_per_lvl=pe.n_feats_per_lvl, hashmap_size=pe.hashmap_size,
        min_res=pe.min_res, max_res_coeff=pe.max_res_coeff, max_bound=max_bound,
        simplex_from=pe.simplex_from,
    )
    field_spec = style_field_spec(
        grid_spec,
        class_dim=train_set.num_classes,
        sh_degree=net_cfg.dir_enc_sh_deg,
        density_hidden_dims=net_cfg.density_hidden_dims,
        density_hidden_layers=net_cfg.density_hidden_layers,
        rgb_hidden_dims=net_cfg.rgb_hidden_dims,
        rgb_hidden_layers=net_cfg.rgb_hidden_layers,
        density_offset=net_cfg.density_offset,
    )
    params = ckpt_lib.restore_tree(param_template(field_spec), groups["params"], dev)
    _check_params(field_spec, params)

    intr = test_set.intr
    if out_dims is not None:
        intr = intr.scale(*out_dims)  # aspect-preserving
    settings = RenderSettings(
        grid_size=render_cfg.grid_size,
        min_near=render_cfg.min_near,
        t_thresh=render_cfg.t_thresh,
        use_ndc=render_cfg.use_ndc,
        flip_camera=render_cfg.flip_camera,
        max_steps=render_cfg.max_steps,
        density_scale=render_cfg.density_scale,
    )
    renderer = Renderer(
        field_spec, train_set.bbox, settings, intr, float(dataset_cfg.bound),
        raymarch_channels=3 + train_set.num_classes,
        compute_dtype=torch.bfloat16 if train_cfg.enable_amp else torch.float32,
        device=dev,
    )
    template = occupancy_persistable(occupancy_init(renderer.cascade, settings.grid_size))
    renderer.restore_occupancy(ckpt_lib.restore_tree(template, groups["occ"]))
    if "renderer_static" in meta:
        renderer.load_state_dict_static(meta["renderer_static"])
    renderer.mesh = mesh
    return renderer, params, test_set, meta


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Render the test poses; returns a summary: frame times, FPS, the
    counters summed over frames and the last frame's outputs."""
    parser = argparse.ArgumentParser(prog="python -m nerfstyle_torch.render")
    parser.add_argument("ckpt_path", type=Path)
    parser.add_argument("--out-dir", type=Path, default=None)
    parser.add_argument("--out-dims", type=int, nargs=2, default=None,
                        help="render resolution W H (rescales intrinsics)")
    parser.add_argument("--max-count", type=int, default=None)
    parser.add_argument("--depth", action="store_true", help="also save depth maps")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--yes", action="store_true", help="assume yes for confirmation prompts")
    parser.add_argument("--dist-backend", default=None, choices=BACKENDS,
                        help="under torchrun: the ranks' backend (nccl on cuda, gloo on the cpu)")
    args = parser.parse_args(argv)
    mesh = init_from_env(args.device, args.dist_backend)
    try:
        return _render(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _render(args, mesh: Optional[Mesh]) -> Dict[str, object]:
    renderer, params, test_set, meta = load_renderer(
        args.ckpt_path, args.device if mesh is None else mesh.device, args.out_dims,
        args.max_count, mesh,
    )
    main_rank = mesh is None or mesh.is_main
    dev = renderer.device
    out_dir = args.out_dir
    if out_dir is None:
        out_dir = Path(meta["log_dir"]) / f"render_{args.ckpt_path.stem}"
    if main_rank:
        out_dir.mkdir(parents=True, exist_ok=True)
        if next(out_dir.iterdir(), None) is not None:
            if utils.prompt_bool(f'Output directory "{out_dir}" is not empty. Clean directory?',
                                 assume_yes=args.yes):
                shutil.rmtree(out_dir)
                out_dir.mkdir()
            else:
                logger.info("Keeping existing files; renders may mix with them.")
    intr = renderer.intr
    if main_rank:
        logger.info("Loaded %s", str(test_set))
        logger.info("Rendering at %dx%d on %s", intr.w, intr.h, dev)

    frame_ms: List[float] = []
    counts = {"num_marched": 0, "num_sig": 0}
    out: Dict[str, object] = {}
    for i in range(len(test_set)):
        _, pose = test_set[i]
        _sync(dev)
        t0 = time.perf_counter()
        out = renderer.render(params, torch.from_numpy(np.asarray(pose)))
        rgb = out["rgb_map"].cpu().numpy()  # waits for the device
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        for k in counts:
            counts[k] += out[k]
        if not main_rank:
            continue
        utils.save_image(rgb.reshape(intr.h, intr.w, 3), out_dir / f"{test_set.fns[i]}.png")
        if args.depth:
            depth = out["trans_map"].cpu().numpy().reshape(intr.h, intr.w)
            utils.save_image(depth[..., None].repeat(3, -1), out_dir / f"{test_set.fns[i]}_depth.png")
        logger.info(
            "Rendered %s in %.1f ms: %d samples marched, %d significant",
            test_set.fns[i], frame_ms[-1], out["num_marched"], out["num_sig"],
        )

    seconds = sum(frame_ms) / 1e3
    fps = len(frame_ms) / seconds if seconds > 0 else 0.0
    if main_rank:
        logger.info("Done: %d frames, %.2f FPS at %dx%d -> %s", len(frame_ms), fps, intr.w,
                    intr.h, out_dir)
    return {
        "frames": len(frame_ms), "frame_ms": frame_ms, "fps": fps, "out_dir": out_dir,
        "intr": intr, "last": out, **counts,
    }
