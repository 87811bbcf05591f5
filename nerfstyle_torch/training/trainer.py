"""Reconstruction-stage trainer (counterpart of
``nerfstyle_tpu/training/trainer.py``, the stage-1 ``Trainer``).

One iteration (:meth:`Trainer.run_iter`), as in the JAX package:

  1. every ``update_iter`` steps (step 0 included) the occupancy grid is
     refreshed (``Renderer.maybe_update_state``: a full sweep before
     ``update_thres`` steps, a random update after; kernel K6, then K6c
     rebuilds the skip distance);
  2. a train frame is drawn (the JAX trainer's numpy stream, same seed) and
     ``num_rays_per_batch`` of its pixels WITH replacement
     (:meth:`ray_batch`);
  3. the batch renders differentiably (``render_rays``: the K3s march
     over the skip distance (``adaptive_march``; K3 without), phase A
     K1 + density MLP + K4, phase B K1 on the [T, 4] tables + MLPs + K4 +
     K7), the losses (MSE, class cross-entropy, optional sparsity and weight
     regularization) backpropagate (K4b, the MLPs by autograd, K2), and
     Adam applies unless a gradient is not finite (``training/optim.py``);
  4. the EMA of the params updates and the batch's marched-sample count
     feeds the grid's ``mean_count``.

With a mesh of more than one rank (``mesh``, :mod:`nerfstyle_torch.parallel`;
JAX's ``trainer.py:250-269`` and ``:458-520``) every rank draws the whole
batch from the same seeded streams and renders its slice of the rays; the
loss terms are sums over the ranks (one all-reduce), turned into means with
the global counts, and the gradients are summed (one all-reduce) before
Adam, so every rank takes the same step and the replicas stay equal.  The
occupancy sweeps and the test frames shard through the ``Renderer``.  Only
rank 0 writes checkpoints, images, logs and scalars.

The TPU package's workarounds are not ported: every buffer is sized from
the counts (no bucket ladders, no kept-prefix budget, no truncation).
Checkpoints are the JAX package's ``.npz`` with the
groups ``params``, ``opt_state``, ``ema`` and ``occ`` in JAX leaf order, so
a checkpoint of either trainer resumes or renders in the other package.
"""

from __future__ import annotations

import json
import math
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device, utils
from ..config import (
    CFGS_ROOT,
    BaseConfig,
    ConfigError,
    DatasetConfig,
    NetworkConfig,
    RendererConfig,
    TrainConfig,
)
from ..core.cameras import camera_dir_grid, pixel_rays, sample_pixels
from ..core.types import DatasetSplit, LossValue
from ..data import get_dataset
from ..losses.recon import cross_entropy_ignore, mse_loss, sparsity_loss, weight_reg_loss
from ..models.fields import (
    Params,
    check_kernel_config,
    field_density,
    field_init,
    make_grid_spec,
    style_field_spec,
)
from ..ops.occupancy import occupancy_init, occupancy_persistable
from ..parallel.mesh import Mesh, active, all_reduce_grads, sharded_loss_terms
from ..render.renderer import Renderer, RenderSettings, render_rays
from . import checkpoint as ckpt_lib
from .ema import EmaState, ema_init, ema_params, ema_update
from .optim import Adam, OptState, keyword_mask, opt_state_from_tree


class ScalarLogger:
    """Scalar metrics, one JSON object a line in ``<log_dir>/scalars.jsonl``."""

    def __init__(self, log_dir: Path):
        self.path = Path(log_dir) / "scalars.jsonl"

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")


def _leaves(params: Params) -> List[Tuple[str, int, torch.Tensor]]:
    out = []
    for k, v in params.items():
        for i, w in enumerate(v if isinstance(v, list) else [v]):
            out.append((k, i, w))
    return out


def _grad_tree(params: Params, total: torch.Tensor) -> Params:
    """The gradient of ``total`` as a params-shaped tree (zeros where a leaf
    does not reach it)."""
    leaves = _leaves(params)
    gs = torch.autograd.grad(total, [w for _, _, w in leaves], allow_unused=True)
    grads: Params = {}
    for (k, i, w), g in zip(leaves, gs):
        g = torch.zeros_like(w) if g is None else g
        if isinstance(params[k], list):
            grads.setdefault(k, []).append(g)
        else:
            grads[k] = g
    return grads


class Trainer:
    OPTIM_KEYS = ["x_density_embedder", "x_color_embedder", "net"]
    # A loss's print and log names (JAX's one map, both stages' keys).
    _PRINT_NAMES = {
        "mse": ("MSE", "mse_loss"),
        "psnr": ("PSNR", "psnr"),
        "class": ("Class", "class_loss"),
        "sparsity": ("Sparsity", "sparsity_loss"),
        "weight_reg": ("Weight Reg.", "weight_reg_loss"),
        "total": ("Total", "total_loss"),
        "content": ("Content", "content_loss"),
        "style": ("Style", "style_loss"),
        "photo": ("Photo", "photo_loss"),
    }

    def __init__(
        self,
        cfg: BaseConfig,
        nargs: List[str],
        device: DeviceLike = None,
        load_model_only: bool = False,
        mesh: Optional[Mesh] = None,
    ):
        """``mesh``: the data-parallel mesh this rank belongs to (None, or a
        mesh of one rank: no sharding)."""
        self.device = resolve_device(device)
        # The ranks (writes and barriers) and the sharding mesh, which is
        # None where the batch does not divide them (as in JAX).
        self.world = active(mesh)
        self.mesh = self.world
        self.is_main = self.world is None or self.world.is_main
        # Rank 0 logs; the others only warn (and end on an error).
        self.logger = utils.create_logger(type(self).__name__,
                                          "info" if self.is_main else "warning")
        # fp32 products must not run in TF32 (see ops/mlp.py).
        torch.backends.cuda.matmul.allow_tf32 = False
        self.iter_ctr = 0
        self.version = utils.get_git_sha()
        self.cfg = cfg

        # load_model_only (the style stage): the checkpoint gives the params
        # and the occupancy grid; the step count, optimizer, EMA and log
        # directory start anew.
        ckpt_meta, ckpt_groups = None, None
        if cfg.ckpt is not None:
            ckpt_meta, ckpt_groups = ckpt_lib.load_checkpoint(cfg.ckpt)
            if not load_model_only:
                self.iter_ctr = int(ckpt_meta["iter_ctr"])

        if ckpt_meta is None or load_model_only:
            if cfg.log_dir is None and ckpt_meta is None:
                raise ConfigError("a log directory (--log-dir) is needed to train from scratch")
            if cfg.log_dir is None:  # a stylization writes beside its checkpoint's run
                cfg.log_dir = Path(ckpt_meta["log_dir"]) / "style"
            self._init_new_log_dir(cfg.log_dir, cfg.yes)
        elif cfg.log_dir is None or str(cfg.log_dir) == ckpt_meta["log_dir"]:
            self.log_dir = Path(ckpt_meta["log_dir"])
            self.log_dir.mkdir(parents=True, exist_ok=True)
        else:
            self._init_new_log_dir(cfg.log_dir, cfg.yes)

        # Config chain: dataset <- train <- network <- renderer; leftover
        # flags are an error.
        if cfg.data_cfg is None:
            if ckpt_meta is None:
                raise ConfigError("a data config (--data-cfg) is needed to train from scratch")
            cfg.data_cfg = Path(ckpt_meta["cfg"]["data_cfg"])
        self.dataset_cfg, nargs = DatasetConfig.load_nargs(cfg.data_cfg, nargs=nargs)
        render_cfg_path = CFGS_ROOT / f"cfgs/renderer/{self.dataset_cfg.type.lower()}.yaml"
        # A style image adds the style stage's train config layer.
        style = cfg.style_image is not None
        train_cfg_path = CFGS_ROOT / "cfgs/training/style.yaml" if style else None
        self.train_cfg, nargs = TrainConfig.load_nargs(train_cfg_path, nargs=nargs)
        self.net_cfg, nargs = NetworkConfig.load_nargs(nargs=nargs)
        self.render_cfg, nargs = RendererConfig.load_nargs(
            render_cfg_path if render_cfg_path.exists() else None, nargs=nargs)
        if nargs:
            raise ConfigError("Unrecognized arguments: " + " ".join(nargs))
        tc = self.train_cfg
        if tc.adaptive_batch:
            raise NotImplementedError("adaptive_batch is a TPU workaround the port does not have")
        check_kernel_config(self.net_cfg, self.device)
        if self.mesh is not None:
            if tc.num_rays_per_batch % self.mesh.size:
                self.logger.warning("num_rays_per_batch (%d) does not divide %d ranks; running "
                                    "unsharded", tc.num_rays_per_batch, self.mesh.size)
                self.mesh = None
            else:
                self.logger.info("Data-parallel over %d ranks (rays sharded, params replicated)",
                                 self.mesh.size)

        dev = self.device
        self._data_gen = torch.Generator(device=dev).manual_seed(tc.rng_seed)
        self._occ_gen = torch.Generator(device=dev).manual_seed(tc.rng_seed + 1)
        # The JAX trainer's frame stream (same seed, same numpy generator).
        self._frame_rng = np.random.default_rng(tc.rng_seed ^ 0x5EED)
        self.writer = ScalarLogger(self.log_dir) if tc.intervals.log > 0 and self.is_main else None

        # Rank 0 loads first: a generated scene is written on its first load.
        if self.world is not None and not self.is_main:
            self.world.barrier()
        self.train_set = get_dataset(self.dataset_cfg, split=DatasetSplit.TRAIN)
        self.logger.info("Loaded %s", str(self.train_set))
        self.test_set = get_dataset(self.dataset_cfg, split=DatasetSplit.TEST,
                                    max_count=tc.max_eval_count)
        self.logger.info("Loaded %s", str(self.test_set))
        if self.world is not None and self.is_main:
            self.world.barrier()
        self.class_cmap = utils.tab10_colormap(max(self.train_set.num_classes, 1))

        pe = self.net_cfg.pos_enc
        grid_spec = make_grid_spec(
            n_lvls=pe.n_lvls, n_feats_per_lvl=pe.n_feats_per_lvl, hashmap_size=pe.hashmap_size,
            min_res=pe.min_res, max_res_coeff=pe.max_res_coeff,
            max_bound=float(self.train_set.bbox.size.max()), simplex_from=pe.simplex_from,
        )
        nc = self.net_cfg
        self.field_spec = style_field_spec(
            grid_spec, class_dim=self.train_set.num_classes,
            density_hidden_dims=nc.density_hidden_dims,
            density_hidden_layers=nc.density_hidden_layers,
            rgb_hidden_dims=nc.rgb_hidden_dims, rgb_hidden_layers=nc.rgb_hidden_layers,
            density_offset=nc.density_offset,
        )
        seed = nc.network_seed if nc.network_seed is not None else tc.rng_seed
        self.params = self._trainable(field_init(self.field_spec,
                                                 torch.Generator().manual_seed(seed), dev))
        self.compute_dtype = torch.bfloat16 if tc.enable_amp else torch.float32

        rc = self.render_cfg
        self.settings = RenderSettings(
            grid_size=rc.grid_size, min_near=rc.min_near, t_thresh=rc.t_thresh,
            use_ndc=rc.use_ndc, flip_camera=rc.flip_camera, max_steps=rc.max_steps,
            density_scale=rc.density_scale, update_iter=rc.update_iter,
            update_thres=rc.update_thres, density_thresh=rc.density_thresh,
            density_decay=rc.density_decay, grid_bsize=rc.grid_bsize,
            max_samples_per_ray=rc.max_samples_per_ray,
            max_budget_samples=rc.max_budget_samples,
        )
        self.renderer = Renderer(
            self.field_spec, self.train_set.bbox, self.settings, self.train_set.intr,
            float(self.dataset_cfg.bound), raymarch_channels=3 + self.train_set.num_classes,
            compute_dtype=self.compute_dtype, device=dev,
        )
        self.renderer.precrop_frac = tc.precrop_fraction
        self.renderer.mesh = self.mesh

        self.optim = Adam(keyword_mask(self.params, self.OPTIM_KEYS),
                          tc.initial_learning_rate, tc.learning_rate_decay)
        n_trainable = sum(w.numel() for k, _, w in _leaves(self.params) if self.optim.mask[k])
        self.logger.info("Optimizing %d parameters from components %s", n_trainable,
                         self.OPTIM_KEYS)
        self.opt_state: OptState = self.optim.init(self.params)
        self.ema_state: EmaState = ema_init(self.params)

        if ckpt_groups is not None:
            self._restore(ckpt_meta, ckpt_groups, load_model_only)
            self.logger.info('Loaded checkpoint "%s"', cfg.ckpt)
        else:
            self.logger.info("Initialized new %s from scratch", type(self).__name__)

        self._stage_train_data()
        self._grids: Dict[float, Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]] = {}
        self.rays_trained = 0
        self.last_losses: Dict[str, torch.Tensor] = {}
        self.last_counts: Dict[str, int] = {}
        self.iter_ms: List[float] = []  # host clock of each run_iter
        self.iter_counts: List[Dict[str, int]] = []  # num_points, num_sig of each step
        self.test_history: List[Dict[str, float]] = []
        self.trace_path: Optional[Path] = None  # the profiler window's trace, once written

    # ---- set-up ----

    def _init_new_log_dir(self, log_dir, assume_yes: bool) -> None:
        """A new, empty log directory (rank 0 asks before it cleans one)."""
        self.log_dir = Path(log_dir)
        if self.is_main:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            if next(self.log_dir.iterdir(), None) is not None:
                if not utils.prompt_bool("Log directory not empty. Clean directory?", assume_yes):
                    sys.exit(1)
                shutil.rmtree(self.log_dir)
                self.log_dir.mkdir()
        if self.world is not None:
            self.world.barrier()

    @staticmethod
    def _trainable(params: Params) -> Params:
        for _, _, w in _leaves(params):
            w.requires_grad_(True)
        return params

    def _stage_train_data(self) -> None:
        """The whole train split on the device, once: [F, C(+1), H, W]."""
        imgs = np.stack([self.train_set[i][0] for i in range(len(self.train_set))])
        self._images_dev = torch.from_numpy(imgs).to(self.device)
        self._poses_dev = torch.from_numpy(np.asarray(self.train_set.poses)).to(self.device)

    def _camera_grid(self, precrop: float):
        """(cam_dirs [g, 3], pixel rows, pixel cols, grid width) on the device."""
        if precrop not in self._grids:
            dirs, ys, xs = camera_dir_grid(self.train_set.intr, self.settings.flip_camera, precrop)
            self._grids[precrop] = (
                torch.from_numpy(dirs.reshape(-1, 3)).to(self.device),
                torch.from_numpy(ys.astype(np.int64)).to(self.device),
                torch.from_numpy(xs.astype(np.int64)).to(self.device),
                dirs.shape[1],
            )
        return self._grids[precrop]

    def _precrop(self) -> float:
        tc = self.train_cfg
        return tc.precrop_fraction if self.iter_ctr < tc.precrop_iterations else 1.0

    # ---- the train step ----

    def sample_batch(self) -> Tuple[int, torch.Tensor]:
        """The next frame (host draw) and pixel indices (drawn on the device)."""
        frame = int(self._frame_rng.integers(0, len(self.train_set)))
        cam_dirs = self._camera_grid(self._precrop())[0]
        idx = sample_pixels(self.train_cfg.num_rays_per_batch, cam_dirs.shape[0],
                            self._data_gen, self.device)
        return frame, idx

    def ray_batch(self, frame: int, idx: torch.Tensor):
        """(origins [K, 3], dirs [K, 3], target [K, C(+1)]) of the pixels
        ``idx`` of the (precropped) grid of train frame ``frame``."""
        cam_dirs, pix_y, pix_x, gw = self._camera_grid(self._precrop())
        pose = self._poses_dev[frame]
        rays = pixel_rays(cam_dirs, pose, idx)
        target = self._images_dev[frame][:, pix_y[idx // gw], pix_x[idx % gw]].T
        return rays.origins, rays.dirs, target

    def loss_and_grads(self, origins: torch.Tensor, dirs: torch.Tensor, target: torch.Tensor,
                       plain: bool = False):
        """Losses (detached), gradients (a params-shaped tree) and the host
        counts ``num_points``/``num_sig`` of one batch (with a mesh: the
        whole batch's, each rank rendering its slice)."""
        if self.mesh is not None:
            return self._sharded_loss_and_grads(origins, dirs, target, plain)
        tc, s, spec = self.train_cfg, self.settings, self.field_spec
        out = render_rays(
            spec, self.renderer.plan, self.params, self.renderer.occ_field,
            self.renderer.bbox, origins, dirs, t_thresh=s.t_thresh,
            density_scale=s.density_scale, compute_dtype=self.compute_dtype,
            two_phase=tc.two_phase_train, plain=plain,
        )
        losses: Dict[str, torch.Tensor] = {}
        mse = mse_loss(out["rgb_map"], target[:, :3])
        losses["mse"] = mse
        losses["psnr"] = -10.0 * torch.log(mse.detach()) / math.log(10.0)
        total = mse
        if spec.class_dim > 0 and target.shape[1] == 4:
            class_l = cross_entropy_ignore(out["classes"], target[:, 3].to(torch.int64))
            losses["class"] = class_l * tc.class_lambda
            total = total + losses["class"]
        if tc.sparsity_lambda > 0.0:
            bbox = self.renderer.bbox
            pts = torch.rand((tc.sparsity_samples, 3), generator=self._data_gen,
                             device=self.device) * bbox.size + bbox.min_pt
            sig = field_density(spec, self.params, bbox, pts, self.compute_dtype, plain=plain)
            losses["sparsity"] = sparsity_loss(sig, tc.sparsity_exp_coeff) * tc.sparsity_lambda
            total = total + losses["sparsity"]
        if tc.weight_reg_lambda > 0.0:
            losses["weight_reg"] = weight_reg_loss(self.params) * tc.weight_reg_lambda
            total = total + losses["weight_reg"]
        losses["total"] = total
        grads = _grad_tree(self.params, total)
        counts = {"num_points": out["num_points"], "num_sig": out["num_sig"]}
        return {k: v.detach() for k, v in losses.items()}, grads, counts

    def _sharded_loss_and_grads(self, origins: torch.Tensor, dirs: torch.Tensor,
                                target: torch.Tensor, plain: bool = False):
        """:meth:`loss_and_grads` over the mesh (JAX ``trainer.py:458-520``):
        the loss terms as sums over the ranks, means over the global counts
        (``3 K``, ``max(n_lab, 1)``, ``n_sparse = max(1, s // n) * n``
        sparsity points drawn whole on every rank), each rank's gradient
        share summed in one all-reduce.  The weight regularizer is
        replicated: only rank 0's backward takes it."""
        tc, s, spec, mesh = self.train_cfg, self.settings, self.field_spec, self.mesh
        has_seg = spec.class_dim > 0 and target.shape[1] == 4
        pts, n_sparse = None, 0
        if tc.sparsity_lambda > 0.0:
            n_sparse = max(1, tc.sparsity_samples // mesh.size) * mesh.size
            bbox = self.renderer.bbox
            pts = torch.rand((n_sparse, 3), generator=self._data_gen,
                             device=self.device) * bbox.size + bbox.min_pt
        terms = sharded_loss_terms(
            mesh, spec, self.renderer.plan, self.params, self.renderer.occ_field,
            self.renderer.bbox, origins, dirs, target, pts, t_thresh=s.t_thresh,
            density_scale=s.density_scale, compute_dtype=self.compute_dtype, with_class=has_seg,
            sparsity_exp_coeff=tc.sparsity_exp_coeff if tc.sparsity_lambda > 0.0 else 0.0,
            two_phase=tc.two_phase_train, plain=plain,
        )
        losses: Dict[str, torch.Tensor] = {}
        mse = terms["sq"] / (3.0 * origins.shape[0])
        losses["mse"] = mse
        losses["psnr"] = -10.0 * torch.log(mse.detach()) / math.log(10.0)
        total = mse
        if has_seg:
            losses["class"] = terms["nll"] / torch.clamp(terms["n_lab"], min=1.0) * tc.class_lambda
            total = total + losses["class"]
        if tc.sparsity_lambda > 0.0:
            losses["sparsity"] = terms["sp"] / n_sparse * tc.sparsity_lambda
            total = total + losses["sparsity"]
        grad_total = total
        if tc.weight_reg_lambda > 0.0:
            losses["weight_reg"] = weight_reg_loss(self.params) * tc.weight_reg_lambda
            total = total + losses["weight_reg"]
            grad_total = total if mesh.is_main else grad_total + losses["weight_reg"].detach()
        losses["total"] = total
        grads = all_reduce_grads(mesh, _grad_tree(self.params, grad_total))
        counts = {"num_points": terms["num_points"], "num_sig": terms["num_sig"]}
        return {k: v.detach() for k, v in losses.items()}, grads, counts

    def apply_grads(self, grads: Params) -> bool:
        """The optimizer update (skipped on non-finite grads) and the EMA
        update (always, as in JAX); True when the update applied."""
        self.opt_state, applied = self.optim.update(grads, self.opt_state, self.params)
        self.ema_state = ema_update(self.ema_state, self.params, self.train_cfg.ema_decay)
        return applied

    # ---- the loop ----

    def run_iter(self) -> None:
        t0 = time.perf_counter()
        self.renderer.maybe_update_state(self.params, self._occ_gen)
        losses, grads, counts = self.loss_and_grads(*self.ray_batch(*self.sample_batch()))
        self.apply_grads(grads)
        num_rays = self.train_cfg.num_rays_per_batch
        self.renderer.note_batch_points(counts["num_points"], num_rays)
        self.rays_trained += num_rays
        self.iter_ctr += 1
        self.last_losses, self.last_counts = losses, counts
        self.iter_ms.append((time.perf_counter() - t0) * 1e3)
        self.iter_counts.append(counts)
        self._after_iter(losses)

    def _after_iter(self, losses: Dict[str, torch.Tensor]) -> None:
        """The interval work after an iteration: status (rank 0), test
        frames (every rank renders its share, rank 0 writes), scalars (rank
        0), checkpoint (rank 0 writes, the others wait)."""
        iv = self.train_cfg.intervals
        if self._check_interval(iv.print) and self.is_main:
            self.print_status(self._to_loss_values(losses))
        if self._check_interval(iv.test):
            self.test_networks()
        if self._check_interval(iv.log) and self.is_main:
            self.log_status(self._to_loss_values(losses))
        if self._check_interval(iv.ckpt, final=True):
            self.save_ckpt()

    def run(self) -> None:
        """Train to ``num_iterations``.  With ``profile_dir`` set, the
        iterations from ``iter_ctr == profile_start`` on, ``profile_steps``
        of them, run under ``torch.profiler`` (the host, and the card on
        CUDA), each in a ``step <iter_ctr>`` range, and the window is written
        to ``profile_dir`` as a Chrome trace (:attr:`trace_path`), also when
        training ends inside it (rank 0's iterations, with a mesh)."""
        tc = self.train_cfg
        if tc.test_before_train:
            self.test_networks()
        prof, first = None, 0
        trace = tc.profile_dir is not None and self.is_main
        try:
            while self.iter_ctr < tc.num_iterations:
                if trace and prof is None and self.iter_ctr == tc.profile_start:
                    prof, first = self._start_trace(), self.iter_ctr
                if prof is None:
                    self.run_iter()
                    continue
                with torch.profiler.record_function(f"step {self.iter_ctr}"):
                    self.run_iter()
                if self.iter_ctr >= tc.profile_start + tc.profile_steps:
                    self._stop_trace(prof, first)
                    prof = None
        finally:
            if prof is not None:
                self._stop_trace(prof, first)

    def _start_trace(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof: torch.profiler.profile, first: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        pdir = Path(self.train_cfg.profile_dir)
        pdir.mkdir(parents=True, exist_ok=True)
        self.trace_path = pdir / f"trace_steps_{first}-{self.iter_ctr - 1}.json"
        prof.export_chrome_trace(str(self.trace_path))
        self.logger.info("Wrote profiler trace to %s", self.trace_path)

    def close(self) -> None:
        self.logger.info("Closed")

    def _check_interval(self, interval: int, after: int = 0, final: bool = False) -> bool:
        if interval <= 0:
            return False
        is_final = final and self.iter_ctr == self.train_cfg.num_iterations
        return (self.iter_ctr % interval == 0 or is_final) and self.iter_ctr > after

    def _to_loss_values(self, losses: Dict[str, torch.Tensor]) -> Dict[str, LossValue]:
        out = {}
        for k, v in losses.items():
            pn, ln = self._PRINT_NAMES.get(k, (k, k))
            out[k] = LossValue(pn, ln, v)
        return out

    def print_status(self, losses: Dict[str, LossValue], phase: str = "TRAIN") -> None:
        items = [f"{lv.print_name}: {float(lv.value):.5f}" for lv in losses.values()]
        self.logger.info("[%s] Iter: %d, %s", phase, self.iter_ctr, ", ".join(items))

    def log_status(self, losses: Dict[str, LossValue]) -> None:
        if self.writer is None:
            return
        for lv in losses.values():
            self.writer.add_scalar(f"train/{lv.log_name}", float(lv.value), self.iter_ctr)
        self.writer.add_scalar("misc/iter_time", self.iter_ms[-1] / 1e3, self.iter_ctr)

    # ---- evaluation ----

    def eval_params(self) -> Params:
        return ema_params(self.ema_state, self.params, self.train_cfg.ema_decay is not None)

    def test_networks(self) -> Dict[str, float]:
        """Render the test split with the EMA params; saves PNGs and returns
        the mean MSE and its PSNR.  With a mesh every rank renders its
        share of each frame and rank 0 saves them."""
        img_dir = self.log_dir / "epoch_{:0{w}d}".format(
            self.iter_ctr, w=len(str(self.train_cfg.num_iterations)))
        if self.is_main:
            img_dir.mkdir(exist_ok=True)
        params = self.eval_params()
        h, w = self.test_set.intr.h, self.test_set.intr.w
        mses = []
        with torch.no_grad():
            for i in range(len(self.test_set)):
                img, pose = self.test_set[i]
                out = self.renderer.render(params, torch.from_numpy(np.asarray(pose)))
                rgb = out["rgb_map"].cpu().numpy()
                if self.is_main:
                    utils.save_image(rgb.reshape(h, w, 3),
                                     img_dir / f"{self.test_set.fns[i]}.png")
                if self.train_set.num_classes > 0 and self.is_main:
                    preds = out["classes"].argmax(dim=1).cpu().numpy().reshape(h, w)
                    utils.save_image(self.class_cmap[preds],
                                     img_dir / f"{self.test_set.fns[i]}_seg.png")
                if self.test_set.has_gt and img is not None:
                    target = np.moveaxis(np.asarray(img)[:3], 0, -1).reshape(-1, 3)
                    mses.append(float(np.mean((rgb - target) ** 2)))
        if not mses:
            return {}
        mse = float(np.mean(mses))
        metrics = {"iter": self.iter_ctr, "mse": mse, "psnr": utils.compute_psnr(mse)}
        if self.is_main:
            self.logger.info("[TEST] Iter: %d, MSE: %.5f, PSNR: %.5f", self.iter_ctr, mse,
                             metrics["psnr"])
        self.test_history.append(metrics)
        return metrics

    # ---- checkpoints ----

    def save_ckpt(self) -> Path:
        path = self.log_dir / "iter_{:0{w}d}.ckpt".format(
            self.iter_ctr, w=len(str(self.train_cfg.num_iterations)))
        meta = {
            "version": self.version,
            "log_dir": str(self.log_dir),
            "iter_ctr": self.iter_ctr,
            "cfg": self.cfg.asdict(),
            "dataset_cfg": self.dataset_cfg.asdict(),
            "train_cfg": self.train_cfg.asdict(),
            "net_cfg": self.net_cfg.asdict(),
            "render_cfg": self.render_cfg.asdict(),
            "renderer_static": self.renderer.state_dict_static(),
            "trainer_static": {"adaptive_rays": None, "sig_bucket_train": None},
        }
        trees = {"params": self.params, "opt_state": self.opt_state, "ema": self.ema_state,
                 "occ": occupancy_persistable(self.renderer.occ_state)}
        if self.is_main:
            ckpt_lib.save_checkpoint(path, meta, trees)
            self.logger.info("Saved checkpoint at %s", path)
        if self.world is not None:
            self.world.barrier()
        return path

    def _restore(self, meta: Dict, groups: Dict, load_model_only: bool = False) -> None:
        dev = self.device
        self.params = self._trainable(ckpt_lib.restore_tree(self.params, groups["params"], dev))
        template = occupancy_persistable(occupancy_init(self.renderer.cascade,
                                                        self.settings.grid_size))
        self.renderer.restore_occupancy(ckpt_lib.restore_tree(template, groups["occ"]))
        sd = meta.get("renderer_static")
        if sd is not None:
            self.renderer.load_state_dict_static(sd)
        if load_model_only:
            return
        try:
            self.opt_state = opt_state_from_tree(
                ckpt_lib.restore_tree(self.opt_state, groups["opt_state"], dev))
        except (ValueError, KeyError):
            self.logger.warning("Checkpoint optimizer state missing or mismatched; "
                                "resuming with a FRESH optimizer state.")
        ema = ckpt_lib.restore_tree(self.ema_state, groups["ema"], dev)
        self.ema_state = EmaState(shadow=ema.shadow, num_updates=ema.num_updates.cpu())


def get_trainer(cfg: BaseConfig, nargs: List[str], device: DeviceLike = None,
                mesh: Optional[Mesh] = None) -> Trainer:
    """The trainer of a run: the style stage when a style image is given,
    else stage 1 (reconstruction); ``mesh``: the rank's data-parallel mesh."""
    if cfg.style_image is None:
        return Trainer(cfg, nargs, device, mesh=mesh)
    from .style_trainer import StyleTrainer

    return StyleTrainer(cfg, nargs, device, mesh=mesh)
