"""Stylization-stage trainer (counterpart of
``nerfstyle_tpu/training/style_trainer.py``).

The stage loads a reconstruction checkpoint (params and occupancy grid
only), and optimizes only the color hash table ``x_color_embedder`` against
VGG16 relu3 losses: a content term against the train view and the semantic
style term against the style image.  The density branch and the occupancy
grid are frozen.  An iteration (:meth:`StyleTrainer.run_iter`) takes one of
two schemes, as in JAX (``style_geom_cache``).

The frozen-geometry cache (the default).  Each pose's geometry (its marched
samples, their densities and compositing weights) is the same at every
iteration, so it is extracted once a pose into a cache
(:meth:`StyleTrainer._build_geom_cache`):

  * the frame's rays march (kernel K3s over the skip distance, or K3 with
    ``adaptive_march`` off), the density branch runs on the whole
    stream (K1 on the density table, K5) and the compositor gives the
    weights and each ray's ``weights_sum`` (K4);
  * the samples with ``w > style_geom_cache_eps`` are kept in ray-major
    order, with ray offsets ``[HW + 1]`` and, where the field reads them,
    their view directions; the weight they drop is at most the logged bound
    a ray;
  * the train view, in ray order, and its relu3 features are kept beside.

An iteration is then one forward and backward over the cached stream: the
color branch (K1 on the color table, the class, color1 and color2 MLPs
through K5, with K5d's colour-head input under ``use_dir``), per-ray sums
with the cached weights (K7), the white-background blend, VGG16 and the
losses; autograd runs back through VGG, K7's backward (K7b), K5's backward
and K2 into ``x_color_embedder``.

The two-pass scheme (``style_geom_cache`` false: the reference's deferred
backprop).  Pass 1 renders the whole frame without gradients through the
train path (:func:`~nerfstyle_torch.render.renderer.render_rays`: K3s, K1,
K5, K4, and K4 again on each ray's kept prefix), ``CHUNK_RAYS`` rays at a
time; the image losses give ``d loss / d pixels``; pass 2 re-renders the
frame in ``defer_patch_size`` windows (:func:`_tile_windows`) under autograd
and pulls each window's pixel cotangents back into the color table (K4b,
K5's backward, K2), summed over the windows.  With the density frozen both
schemes composite the same samples, so at ``style_geom_cache_eps`` 0 they
agree up to float reassociation.  Unlike JAX's window budgets, the port
never truncates a window.

Both schemes end in Adam (eps 1e-15, skipped on a non-finite gradient) on
that table alone.  There is no EMA update.  The first iteration computes
the Hungarian class-to-cluster matching from the render.

With a data-parallel mesh (:mod:`nerfstyle_torch.parallel`; JAX
``style_trainer.py:282-310`` and ``:724-783``) every rank builds the same
pose caches and takes the same poses.  A cached step colours rank r's rows
``[r S // n, (r + 1) S // n)`` of the cache's stream of S samples (any S;
JAX splits only when n divides S) and segment-sums a partial image (K7);
one all-reduce gives every rank the whole image, the VGG loss and the
matching run replicated, and one all-reduce sums the table gradients.  In
the two-pass scheme pass 1 renders each rank's slice of each chunk and
gathers the frame; pass 2 gives each rank a slice of each window's rays and
their cotangents (no window is truncated: JAX splits each window's budget
evenly) and sums the gradients in one all-reduce after the last window.

Not ported: the TPU's windowed step (``style_step_window_slots``: it bounds
JAX's sort temporaries, which the port's atomic K2 does not have), the
significant-sample and window budget ladders, Wikiart, the GIF collage.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, utils
from ..config import BaseConfig, ConfigError, ConfigValue
from ..core.cameras import camera_dir_grid
from ..core.types import RayBundle, make_rays
from ..data.style import SingleImage
from ..losses.recon import mse_loss
from ..losses.style import get_style_loss
from ..models.fields import Params, field_color, field_density
from ..models.vgg import VGG16FeatureExtractor, VggParams
from ..ops.aabb import near_far_from_aabb
from ..ops.compositing import sample_weights, segment_sum, segment_sum_grad
from ..ops.marching import march_rays
from ..parallel.mesh import Mesh, all_reduce_grads, rank_sum
from ..render.renderer import CHUNK_RAYS, FIELD_BATCH, _batched, render_rays
from .trainer import Trainer, _leaves

Cache = Dict[str, torch.Tensor]


def _tile_windows(w: int, h: int, pw: int, ph: int):
    """Equal-shape window tiling of a w x h frame with ownership masks (a
    copy of the JAX package's).

    Returns (idx [G, pw*ph] int32 flat pixel indices, own [G, pw*ph] f32).
    Border windows shift inward so every window is exactly pw x ph; each
    pixel is OWNED by the window of its unshifted tile, so overlapping
    pixels contribute their cotangent exactly once.
    """
    gx = max(1, -(-w // pw))
    gy = max(1, -(-h // ph))
    idx_list, own_list = [], []
    for j in range(gy):
        sy = min(j * ph, h - ph)
        for i in range(gx):
            sx = min(i * pw, w - pw)
            ys, xs = np.meshgrid(
                np.arange(sy, sy + ph), np.arange(sx, sx + pw), indexing="ij"
            )
            idx_list.append((ys * w + xs).reshape(-1).astype(np.int32))
            x_tile = np.minimum(xs // pw, gx - 1)
            y_tile = np.minimum(ys // ph, gy - 1)
            own = (x_tile == i) & (y_tile == j)
            own_list.append(own.reshape(-1).astype(np.float32))
    return np.stack(idx_list), np.stack(own_list)


class StyleTrainer(Trainer):
    OPTIM_KEYS = ["x_color_embedder"]
    # The phases of a two-pass iteration, in order (two_pass_ms).
    TWO_PASS_PHASES = ("pass 1", "pixel grad", "pass 2", "optimizer")

    def __init__(self, cfg: BaseConfig, nargs: List[str], device: DeviceLike = None,
                 vgg_params: Optional[VggParams] = None, mesh: Optional[Mesh] = None):
        """``vgg_params`` replaces the extractor's weights (the tests carry
        the JAX package's fallback filters over this way); ``mesh``: the
        rank's data-parallel mesh."""
        if cfg.style_image is None:
            raise ConfigError("the style stage needs a style image (--style-image)")
        if cfg.style_image is ConfigValue.EmptyPassed:
            raise NotImplementedError("multi-style (Wikiart) training is dormant in the "
                                      "reference and not ported")
        super().__init__(cfg, nargs, device, load_model_only=True, mesh=mesh)
        tc = self.train_cfg
        keys = ["relu3"]
        self.content_feat = "relu3"
        self.fx = VGG16FeatureExtractor(keys, device=self.device, params=vgg_params)
        matching = None
        if tc.style_matching is not None:
            matching = [int(c) for c in tc.style_matching.split(",")]
        self.style_loss = get_style_loss("SemanticStyleLoss", keys,
                                         clusters_path=tc.style_seg_path, matching=matching)
        w, h = self.train_set.intr.size()
        self.style_train_set = SingleImage(cfg.style_image, max(w, h))
        self.logger.info("Loaded %s", str(self.style_train_set))
        self.style_image = torch.from_numpy(self.style_train_set[0]).to(self.device)
        with torch.no_grad():
            self.style_loss.init_feats(self.fx(self.style_image),
                                       num_classes=self.train_set.num_classes)

        # Pose caches in LRU order (a hit moves its pose to the end).
        self._geom_cache: Dict[int, Cache] = {}
        self.cache_stats: List[Dict[str, float]] = []  # one entry a build
        self._frame: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        self._windows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._data_iter = self.train_set.iter_shuffled_indexed(seed=tc.rng_seed)
        self.loss_history: List[Dict[str, torch.Tensor]] = []  # each step's, on the device
        # Each two-pass iteration's host ms by phase (TWO_PASS_PHASES), beside iter_ms.
        self.two_pass_ms: List[Dict[str, float]] = []

    def _trainable(self, params: Params) -> Params:
        """Only the optimized tables ask for a gradient."""
        mask = {k: any(kw in k for kw in self.OPTIM_KEYS) for k in params}
        for k, _, w in _leaves(params):
            w.requires_grad_(mask[k])
        return params

    # ---- the frame ----

    def _frame_grid(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Camera-frame directions [HW, 3] of the full frame and its pixel
        rows and columns (the maps that put an image in ray order)."""
        if self._frame is None:
            dirs, ys, xs = camera_dir_grid(self.train_set.intr, self.settings.flip_camera)
            self._frame = (torch.from_numpy(dirs.reshape(-1, 3)).to(self.device),
                           torch.from_numpy(ys.astype(np.int64)).to(self.device),
                           torch.from_numpy(xs.astype(np.int64)).to(self.device))
        return self._frame

    def pose_rays(self, pose_idx: int, pixels: Optional[torch.Tensor] = None) -> RayBundle:
        """The rays of train pose ``pose_idx``: every pixel of the frame in
        ray order, or the flat pixel indices ``pixels``."""
        cam_dirs, _, _ = self._frame_grid()
        if pixels is not None:
            cam_dirs = cam_dirs[pixels]
        pose = self._poses_dev[pose_idx]
        return make_rays(pose[:3, 3], cam_dirs @ pose[:3, :3].T)

    def target(self, pose_idx: int) -> torch.Tensor:
        """The train view [3, H, W] in ray order."""
        _, ys, xs = self._frame_grid()
        return self._images_dev[pose_idx][:3][:, ys][:, :, xs].contiguous()

    # ---- the frozen-geometry cache ----

    @torch.no_grad()
    def _build_geom_cache(self, pose_idx: int) -> Cache:
        """The pose's weight-significant samples: ``xyz`` [S, 3], ``w`` [S],
        ray ``offsets`` [HW + 1] i64, ``acc_ws`` [HW] (every sample's
        weight), ``dirs`` [S, 3] where the field reads the view direction,
        the train view ``target_chw`` [3, H, W] in ray order and its relu3
        features ``tgt_feat``."""
        t0 = time.perf_counter()
        s, plan, dev = self.settings, self.renderer.plan, self.device
        eps = float(self.train_cfg.style_geom_cache_eps)
        use_dirs = self.field_spec.needs_dirs
        rays = self.pose_rays(pose_idx)
        hw = rays.dirs.shape[0]
        xyz, dirs, wts, counts, acc_ws = [], [], [], [], []
        drop_max, n_marched = 0.0, 0
        for i in range(0, hw, CHUNK_RAYS):
            o, d = rays.origins[i:i + CHUNK_RAYS], rays.dirs[i:i + CHUNK_RAYS]
            nears, fars = near_far_from_aabb(o, d, plan.aabb(dev), plan.min_near)
            sb = march_rays(plan, self.renderer.occ_field, o, d, nears, fars)
            sigmas = _batched(lambda p: field_density(self.field_spec, self.params,
                                                      self.renderer.bbox, p, self.compute_dtype),
                              sb.xyz, FIELD_BATCH) * s.density_scale
            w, ws, _, _ = sample_weights(sigmas, sb.tau, sb.offsets, plan.dt, s.t_thresh)
            keep = w > eps
            idx = torch.nonzero(keep).squeeze(1)
            kept_before = torch.zeros(keep.shape[0] + 1, dtype=torch.int64, device=dev)
            kept_before[1:] = torch.cumsum(keep, 0)
            sig_off = kept_before[sb.offsets]
            # The weight each ray drops: the cache's exact error bound a pixel.
            dropped = segment_sum(torch.where(keep, 0.0, w), torch.ones_like(w)[:, None],
                                  sb.offsets)
            if dropped.numel():
                drop_max = max(drop_max, float(dropped.max()))
            xyz.append(sb.xyz[idx])
            if use_dirs:
                dirs.append(sb.dirs[idx])
            wts.append(w[idx])
            counts.append(sig_off[1:] - sig_off[:-1])
            acc_ws.append(ws)
            n_marched += sb.num_kept
        offsets = torch.zeros(hw + 1, dtype=torch.int64, device=dev)
        offsets[1:] = torch.cumsum(torch.cat(counts), 0)
        target = self.target(pose_idx)
        cache = {
            "xyz": torch.cat(xyz).contiguous(),
            "w": torch.cat(wts).contiguous(),
            "offsets": offsets,
            "acc_ws": torch.cat(acc_ws),
            "target_chw": target,
            "tgt_feat": self.fx(target)[self.content_feat],
        }
        if use_dirs:
            cache["dirs"] = torch.cat(dirs).contiguous()
        n_sig = cache["w"].shape[0]
        nbytes = self._cache_nbytes(cache)
        stats = {"pose": pose_idx, "num_sig": n_sig, "sig_per_ray": n_sig / hw,
                 "marched_per_ray": n_marched / hw, "bytes": nbytes, "drop_max": drop_max,
                 "build_ms": (time.perf_counter() - t0) * 1e3}
        self.cache_stats.append(stats)
        self.logger.info("Pose %d geometry cache: %d significant samples (%.1f/ray of %.1f "
                         "marched), %.1f MB, max dropped weight/ray %.2e, built in %.1f ms",
                         pose_idx, n_sig, n_sig / hw, n_marched / hw, nbytes / 1e6, drop_max,
                         stats["build_ms"])
        return cache

    @staticmethod
    def _cache_nbytes(cache: Cache) -> int:
        return sum(v.numel() * v.element_size() for v in cache.values())

    def _evict_geom_caches(self, keep: int) -> None:
        """Drop the least recently used pose caches (never ``keep``) beyond
        ``style_geom_cache_max_poses`` poses or ``style_geom_cache_bytes``
        bytes (0: no bound)."""
        tc = self.train_cfg
        cap, max_bytes = tc.style_geom_cache_max_poses, float(tc.style_geom_cache_bytes)

        def over() -> bool:
            if cap > 0 and len(self._geom_cache) > cap:
                return True
            return (max_bytes > 0 and len(self._geom_cache) > 1
                    and sum(map(self._cache_nbytes, self._geom_cache.values())) > max_bytes)

        while over():
            del self._geom_cache[next(k for k in self._geom_cache if k != keep)]

    def geom_cache(self, pose_idx: int) -> Cache:
        """The pose's cache, built on its first use, and now the most recent."""
        cache = self._geom_cache.pop(pose_idx, None)
        if cache is None:
            cache = self._build_geom_cache(pose_idx)
        self._geom_cache[pose_idx] = cache
        self._evict_geom_caches(keep=pose_idx)
        return cache

    # ---- the cached step ----

    def render_cache(self, params: Params, cache: Cache, plain: bool = False):
        """(rgb_map [HW, 3], class logits [HW, K]) of the cached stream: the
        color branch, per-ray sums with the cached weights (K7, backward
        K7b) and the white background.  With a mesh each rank colours its
        rows of the stream and the partial images are summed over the
        ranks (:func:`~nerfstyle_torch.parallel.mesh.rank_sum`)."""
        xyz, w, offsets, dirs = cache["xyz"], cache["w"], cache["offsets"], cache.get("dirs")
        if self.mesh is not None:
            sl = self.mesh.rows(w.shape[0])
            xyz, w, dirs = xyz[sl], w[sl], None if dirs is None else dirs[sl]
            offsets = torch.clamp(offsets - sl.start, min=0, max=sl.stop - sl.start)
        ch = field_color(self.field_spec, params, self.renderer.bbox, xyz, self.compute_dtype,
                         dirs=dirs, plain=plain)
        img = segment_sum_grad(w, ch, offsets, plain=plain)
        if self.mesh is not None:
            img = rank_sum(self.mesh, img)
        return img[:, :3] + (1.0 - cache["acc_ws"])[:, None], img[:, 3:]

    def _image_losses(self, rgb_map: torch.Tensor, target_chw: torch.Tensor,
                      preds: torch.Tensor, target_content_feat: Optional[torch.Tensor] = None):
        """(total, {"content", "style", "total"}) of a rendered frame
        ``rgb_map`` [HW, 3] against the train view [3, H, W] and the style
        image, given the render's class map ``preds`` [H, W]."""
        w, h = self.train_set.intr.size()
        rgb_feats = self.fx(rgb_map.T.reshape(3, h, w))
        if target_content_feat is None:
            target_content_feat = self.fx(target_chw)[self.content_feat]
        content = mse_loss(rgb_feats[self.content_feat], target_content_feat)
        style = self.style_loss(rgb_feats, None, preds, self.iter_ctr)
        content = content * self.train_cfg.content_lambda
        style = style * self.train_cfg.style_lambda
        total = content + style
        return total, {"content": content, "style": style, "total": total}

    def _preds(self, cls: torch.Tensor) -> torch.Tensor:
        w, h = self.train_set.intr.size()
        return cls.detach().argmax(dim=1).reshape(h, w)

    @torch.no_grad()
    def _update_matching(self, rgb_map: torch.Tensor, preds: torch.Tensor) -> None:
        w, h = self.train_set.intr.size()
        feats = self.fx(rgb_map.T.reshape(3, h, w))[self.style_loss.keys[0]][0]
        self.style_loss.update_matching(feats, preds)
        self.logger.info("Style matching: %s", [int(m) for m in self.style_loss.matching])

    @torch.no_grad()
    def init_matching(self, cache: Cache) -> None:
        """The Hungarian class-to-cluster matching, from the render of a
        cache."""
        rgb_map, cls = self.render_cache(self.params, cache)
        self._update_matching(rgb_map, self._preds(cls))

    def _table_grads(self, gs) -> Params:
        """The gradient tree of the optimized tables' gradients ``gs`` (the
        other leaves: None)."""
        keys = [k for k in self.params if self.optim.mask[k]]
        grads: Params = {k: None for k in self.params}
        grads.update(zip(keys, gs))
        return grads

    def loss_and_grads(self, cache: Cache, plain: bool = False):
        """Losses (detached) and the gradient of every optimized table (the
        other leaves: None) of one step over a pose cache."""
        rgb_map, cls = self.render_cache(self.params, cache, plain)
        total, losses = self._image_losses(rgb_map, cache["target_chw"], self._preds(cls),
                                           cache["tgt_feat"])
        gs = torch.autograd.grad(total, [self.params[k] for k in self.params
                                         if self.optim.mask[k]])
        grads = self._table_grads(gs)
        if self.mesh is not None:
            grads = all_reduce_grads(self.mesh, grads)
        return {k: v.detach() for k, v in losses.items()}, grads

    # ---- the two-pass step ----

    def _render_rays(self, params: Params, rays: RayBundle, plain: bool = False):
        s = self.settings
        return render_rays(self.field_spec, self.renderer.plan, params, self.renderer.occ_field,
                           self.renderer.bbox, rays.origins, rays.dirs, t_thresh=s.t_thresh,
                           density_scale=s.density_scale, compute_dtype=self.compute_dtype,
                           plain=plain)

    @torch.no_grad()
    def render_frame(self, params: Params, pose_idx: int, plain: bool = False):
        """Pass 1: (rgb_map [HW, 3], class logits [HW, K]) of train pose
        ``pose_idx`` through the train path, ``CHUNK_RAYS`` rays at a time,
        without gradients (with a mesh: each rank's slice of a chunk,
        gathered)."""
        rays = self.pose_rays(pose_idx)
        outs = []
        for i in range(0, len(rays), CHUNK_RAYS):
            o, d = rays.origins[i:i + CHUNK_RAYS], rays.dirs[i:i + CHUNK_RAYS]
            if self.mesh is None:
                outs.append(self._render_rays(params, RayBundle(o, d), plain))
                continue
            sl = self.mesh.rows(o.shape[0])
            out = self._render_rays(params, RayBundle(o[sl], d[sl]), plain)
            whole = self.mesh.all_gather_rows(torch.cat([out["rgb_map"], out["classes"]], 1),
                                              o.shape[0])
            outs.append({"rgb_map": whole[:, :3], "classes": whole[:, 3:]})
        return (torch.cat([o["rgb_map"] for o in outs]),
                torch.cat([o["classes"] for o in outs]))

    def pixel_grad(self, rgb_map: torch.Tensor, target_chw: torch.Tensor, preds: torch.Tensor):
        """Losses (detached) and ``d total / d rgb_map`` [HW, 3] of a
        rendered frame."""
        with torch.enable_grad():
            leaf = rgb_map.detach().requires_grad_(True)
            total, losses = self._image_losses(leaf, target_chw, preds)
            (g,) = torch.autograd.grad(total, leaf)
        return {k: v.detach() for k, v in losses.items()}, g

    def window_tiling(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(idx [G, pw*ph] i64, own [G, pw*ph] f32) of the frame's
        ``defer_patch_size`` windows (:func:`_tile_windows`), on the
        device."""
        if self._windows is None:
            w, h = self.train_set.intr.size()
            ps = self.train_cfg.defer_patch_size
            idx, own = _tile_windows(w, h, min(ps, w), min(ps, h))
            self._windows = (torch.from_numpy(idx.astype(np.int64)).to(self.device),
                             torch.from_numpy(own).to(self.device))
        return self._windows

    def window_grads(self, params: Params, pose_idx: int, pixel_grad: torch.Tensor,
                     plain: bool = False) -> Params:
        """Pass 2: each window of train pose ``pose_idx`` re-rendered through
        the train path under autograd and the VJP of its owned pixels'
        cotangents ``pixel_grad`` [HW, 3] taken into the optimized tables,
        summed over the windows.  A window that marches no sample has zero
        gradient and is skipped.  With a mesh each rank takes its slice of
        each window's rays and their cotangents, and the sum of the windows
        is summed over the ranks in one all-reduce."""
        tables = [params[k] for k in params if self.optim.mask[k]]
        acc = [torch.zeros_like(t) for t in tables]
        for idx, own in zip(*self.window_tiling()):
            if self.mesh is not None:
                sl = self.mesh.rows(idx.shape[0])
                idx, own = idx[sl], own[sl]
            out = self._render_rays(params, self.pose_rays(pose_idx, idx), plain)
            if out["num_points"] == 0:
                continue
            gs = torch.autograd.grad(out["rgb_map"], tables, pixel_grad[idx] * own[:, None])
            for a, g in zip(acc, gs):
                a.add_(g)
        grads = self._table_grads(acc)
        if self.mesh is not None:
            grads = all_reduce_grads(self.mesh, grads)
        return grads

    def _run_iter_two_pass(self, pose_idx: int) -> Dict[str, torch.Tensor]:
        """Pass 1, the pixel gradient, pass 2 and Adam; each phase's host
        ms (ended by a device sync on CUDA) into ``two_pass_ms``."""
        cuda = self.device.type == "cuda"
        marks = [time.perf_counter()]

        def mark() -> None:
            if cuda:
                torch.cuda.synchronize(self.device)
            marks.append(time.perf_counter())

        rgb_map, cls = self.render_frame(self.params, pose_idx)
        preds = self._preds(cls)
        if self.style_loss.use_matching and self.style_loss.matching is None:
            self._update_matching(rgb_map, preds)
        mark()
        losses, pixel_grad = self.pixel_grad(rgb_map, self.target(pose_idx), preds)
        mark()
        grads = self.window_grads(self.params, pose_idx, pixel_grad)
        mark()
        self.opt_state, _ = self.optim.update(grads, self.opt_state, self.params)
        mark()
        self.two_pass_ms.append({k: (b - a) * 1e3 for k, a, b in
                                 zip(self.TWO_PASS_PHASES, marks, marks[1:])})
        return losses

    # ---- the loop ----

    def run_iter(self) -> None:
        t0 = time.perf_counter()
        pose_idx, _ = next(self._data_iter)
        if self.train_cfg.style_geom_cache:
            cache = self.geom_cache(pose_idx)
            if self.style_loss.use_matching and self.style_loss.matching is None:
                self.init_matching(cache)
            losses, grads = self.loss_and_grads(cache)
            self.opt_state, _ = self.optim.update(grads, self.opt_state, self.params)
        else:
            losses = self._run_iter_two_pass(pose_idx)
        # No EMA update in the style stage.
        self.iter_ctr += 1
        self.last_losses = losses
        self.loss_history.append(losses)
        self.iter_ms.append((time.perf_counter() - t0) * 1e3)
        self._after_iter(losses)

    # ---- evaluation ----

    def test_networks(self) -> Dict[str, float]:
        """Render the test views with the current params; each frame is
        saved as a PNG, and the frames' collages with the style image as
        ``video.gif`` (3.75 frames a second, looping), as the JAX package
        does.  With a mesh every rank renders its share of each frame and
        rank 0 writes."""
        img_dir = self.log_dir / "epoch_{:0{w}d}".format(
            self.iter_ctr, w=len(str(self.train_cfg.num_iterations)))
        if self.is_main:
            img_dir.mkdir(exist_ok=True)
        h, w = self.test_set.intr.h, self.test_set.intr.w
        style = self.style_image.cpu().numpy()
        frames = []
        with torch.no_grad():
            for i in range(len(self.test_set)):
                _, pose = self.test_set[i]
                out = self.renderer.render(self.params, torch.from_numpy(np.asarray(pose)))
                rgb = out["rgb_map"].cpu().numpy().T.reshape(3, h, w)
                collage = utils.collage_h(rgb, style[:3])
                frames.append((np.clip(np.moveaxis(collage, 0, -1), 0, 1) * 255).astype(np.uint8))
                if self.is_main:
                    utils.save_image(rgb, img_dir / f"{self.test_set.fns[i]}.png")
        if self.is_main:
            utils.save_gif(frames, img_dir / "video.gif", fps=3.75)
        return {}
