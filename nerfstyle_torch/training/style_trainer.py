"""Stylization-stage trainer (counterpart of
``nerfstyle_tpu/training/style_trainer.py``, the frozen-geometry path).

The stage loads a reconstruction checkpoint (params and occupancy grid
only), and optimizes only the color hash table ``x_color_embedder`` against
VGG16 relu3 losses: a content term against the train view and the semantic
style term against the style image.  The density branch and the occupancy
grid are frozen, so each pose's geometry (its marched samples, their
densities and compositing weights) is the same at every iteration; it is
extracted once a pose into a cache (:meth:`StyleTrainer._build_geom_cache`):

  * the frame's rays march (kernel K3s over the skip distance, or K3 with
    ``adaptive_march`` off), the density branch runs on the whole
    stream (K1 on the density table, K5) and the compositor gives the
    weights and each ray's ``weights_sum`` (K4);
  * the samples with ``w > style_geom_cache_eps`` are kept in ray-major
    order, with ray offsets ``[HW + 1]``; the weight they drop is at most the
    logged bound a ray;
  * the train view, in ray order, and its relu3 features are kept beside.

An iteration (:meth:`StyleTrainer.run_iter`) is then one forward and backward
over the cached stream: the color branch (K1 on the color table, the class,
color1 and color2 MLPs through K5), per-ray sums with the cached weights (K7),
the white-background blend, VGG16 and the losses; autograd runs back through
VGG, K7's backward (K7b), K5's backward and K2 into ``x_color_embedder``,
and Adam (eps 1e-15, skipped on a non-finite gradient) updates that table
alone.  There is no EMA update.  The first iteration computes the Hungarian
class-to-cluster matching from the render.

Not ported: the reference-shaped two-pass scheme (``style_geom_cache``
false raises), the TPU's windowed step (``style_step_window_slots``: it
bounds JAX's sort temporaries, which the port's atomic K2 does not have) and
its significant-sample bucket ladder, Wikiart, the GIF collage, mesh
sharding.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, utils
from ..config import BaseConfig, ConfigError, ConfigValue
from ..core.cameras import camera_dir_grid
from ..core.types import make_rays
from ..data.style import SingleImage
from ..losses.recon import mse_loss
from ..losses.style import get_style_loss
from ..models.fields import Params, field_color, field_density
from ..models.vgg import VGG16FeatureExtractor, VggParams
from ..ops.aabb import near_far_from_aabb
from ..ops.compositing import sample_weights, segment_sum, segment_sum_grad
from ..ops.marching import march_rays
from ..render.renderer import CHUNK_RAYS, FIELD_BATCH, _batched
from .trainer import Trainer, _leaves

Cache = Dict[str, torch.Tensor]


class StyleTrainer(Trainer):
    OPTIM_KEYS = ["x_color_embedder"]
    _PRINT_NAMES = {"content": "Content", "style": "Style", "total": "Total"}
    _LOG_NAMES = {"content": "content_loss", "style": "style_loss", "total": "total_loss"}

    def __init__(self, cfg: BaseConfig, nargs: List[str], device: DeviceLike = None,
                 vgg_params: Optional[VggParams] = None):
        """``vgg_params`` replaces the extractor's weights (the tests carry
        the JAX package's fallback filters over this way)."""
        if cfg.style_image is None:
            raise ConfigError("the style stage needs a style image (--style-image)")
        if cfg.style_image is ConfigValue.EmptyPassed:
            raise NotImplementedError("multi-style (Wikiart) training is dormant in the "
                                      "reference and not ported")
        super().__init__(cfg, nargs, device, load_model_only=True)
        tc = self.train_cfg
        if not tc.style_geom_cache:
            raise NotImplementedError("the two-pass style scheme (style_geom_cache false) is not "
                                      "ported yet")
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
        self._data_iter = self.train_set.iter_shuffled_indexed(seed=tc.rng_seed)
        self.loss_history: List[Dict[str, torch.Tensor]] = []  # each step's, on the device

    def _trainable(self, params: Params) -> Params:
        """Only the optimized tables ask for a gradient."""
        mask = {k: any(kw in k for kw in self.OPTIM_KEYS) for k in params}
        for k, _, w in _leaves(params):
            w.requires_grad_(mask[k])
        return params

    # ---- the frozen-geometry cache ----

    def _frame_grid(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Camera-frame directions [HW, 3] of the full frame and its pixel
        rows and columns (the maps that put an image in ray order)."""
        if self._frame is None:
            dirs, ys, xs = camera_dir_grid(self.train_set.intr, self.settings.flip_camera)
            self._frame = (torch.from_numpy(dirs.reshape(-1, 3)).to(self.device),
                           torch.from_numpy(ys.astype(np.int64)).to(self.device),
                           torch.from_numpy(xs.astype(np.int64)).to(self.device))
        return self._frame

    @torch.no_grad()
    def _build_geom_cache(self, pose_idx: int) -> Cache:
        """The pose's weight-significant samples: ``xyz`` [S, 3], ``w`` [S],
        ray ``offsets`` [HW + 1] i64, ``acc_ws`` [HW] (every sample's
        weight), the train view ``target_chw`` [3, H, W] in ray order and its
        relu3 features ``tgt_feat``."""
        t0 = time.perf_counter()
        s, plan, dev = self.settings, self.renderer.plan, self.device
        eps = float(self.train_cfg.style_geom_cache_eps)
        cam_dirs, ys, xs = self._frame_grid()
        pose = self._poses_dev[pose_idx]
        rays = make_rays(pose[:3, 3], cam_dirs @ pose[:3, :3].T)
        hw = rays.dirs.shape[0]
        xyz, wts, counts, acc_ws = [], [], [], []
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
            wts.append(w[idx])
            counts.append(sig_off[1:] - sig_off[:-1])
            acc_ws.append(ws)
            n_marched += sb.num_kept
        offsets = torch.zeros(hw + 1, dtype=torch.int64, device=dev)
        offsets[1:] = torch.cumsum(torch.cat(counts), 0)
        target = self._images_dev[pose_idx][:3][:, ys][:, :, xs].contiguous()
        cache = {
            "xyz": torch.cat(xyz).contiguous(),
            "w": torch.cat(wts).contiguous(),
            "offsets": offsets,
            "acc_ws": torch.cat(acc_ws),
            "target_chw": target,
            "tgt_feat": self.fx(target)[self.content_feat],
        }
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

    # ---- the step ----

    def render_cache(self, params: Params, cache: Cache, plain: bool = False):
        """(rgb_map [HW, 3], class logits [HW, K]) of the cached stream: the
        color branch, per-ray sums with the cached weights (K7, backward
        K7b) and the white background."""
        ch = field_color(self.field_spec, params, self.renderer.bbox, cache["xyz"],
                         self.compute_dtype, plain=plain)
        img = segment_sum_grad(cache["w"], ch, cache["offsets"], plain=plain)
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
    def init_matching(self, cache: Cache) -> None:
        """The Hungarian class-to-cluster matching, from the render of a
        cache."""
        w, h = self.train_set.intr.size()
        rgb_map, cls = self.render_cache(self.params, cache)
        feats = self.fx(rgb_map.T.reshape(3, h, w))[self.style_loss.keys[0]][0]
        self.style_loss.update_matching(feats, self._preds(cls))
        self.logger.info("Style matching: %s", [int(m) for m in self.style_loss.matching])

    def loss_and_grads(self, cache: Cache, plain: bool = False):
        """Losses (detached) and the gradient of every optimized table (the
        other leaves: None) of one step over a pose cache."""
        rgb_map, cls = self.render_cache(self.params, cache, plain)
        total, losses = self._image_losses(rgb_map, cache["target_chw"], self._preds(cls),
                                           cache["tgt_feat"])
        keys = [k for k in self.params if self.optim.mask[k]]
        gs = torch.autograd.grad(total, [self.params[k] for k in keys])
        grads: Params = {k: None for k in self.params}
        grads.update(zip(keys, gs))
        return {k: v.detach() for k, v in losses.items()}, grads

    def run_iter(self) -> None:
        t0 = time.perf_counter()
        pose_idx, _ = next(self._data_iter)
        cache = self.geom_cache(pose_idx)
        if self.style_loss.use_matching and self.style_loss.matching is None:
            self.init_matching(cache)
        losses, grads = self.loss_and_grads(cache)
        self.opt_state, _ = self.optim.update(grads, self.opt_state, self.params)
        # No EMA update in the style stage.
        self.iter_ctr += 1
        self.last_losses = losses
        self.loss_history.append(losses)
        self.iter_ms.append((time.perf_counter() - t0) * 1e3)

        iv = self.train_cfg.intervals
        if self._check_interval(iv.print):
            self.print_status(losses)
        if self._check_interval(iv.test):
            self.test_networks()
        if self._check_interval(iv.log):
            self.log_status(losses)
        if self._check_interval(iv.ckpt, final=True):
            self.save_ckpt()

    # ---- evaluation ----

    def test_networks(self) -> Dict[str, float]:
        """Render the test views with the current params; each frame and its
        collage with the style image are saved as PNGs."""
        img_dir = self.log_dir / "epoch_{:0{w}d}".format(
            self.iter_ctr, w=len(str(self.train_cfg.num_iterations)))
        img_dir.mkdir(exist_ok=True)
        h, w = self.test_set.intr.h, self.test_set.intr.w
        style = self.style_image.cpu().numpy()
        with torch.no_grad():
            for i in range(len(self.test_set)):
                _, pose = self.test_set[i]
                out = self.renderer.render(self.params, torch.from_numpy(np.asarray(pose)))
                rgb = out["rgb_map"].cpu().numpy().T.reshape(3, h, w)
                utils.save_image(rgb, img_dir / f"{self.test_set.fns[i]}.png")
                utils.save_image(utils.collage_h(rgb, style[:3]),
                                 img_dir / f"{self.test_set.fns[i]}_collage.png")
        return {}
