"""Style-transfer losses (counterpart of ``nerfstyle_tpu/losses/style.py``).

Gram, AdaIN, NNFM, the paper's SemanticStyleLoss (segment-matched
nearest-neighbour feature matching with a Hungarian class-to-cluster
assignment) and the MattingLaplacian photorealism term, over [N, C, H, W]
feature dicts.  The index laws of the JAX package are reproduced exactly
(:func:`labels_downscale`, :func:`_interpolate_nearest`), and the masked
nearest-neighbour minimum is ``torch.amin``, whose gradient splits evenly
among ties as ``jnp.min``'s does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .assignment import linear_sum_assignment


def compute_centroid(mask: torch.Tensor) -> torch.Tensor:
    """Normalized (row, col) centroid of a boolean [H, W] mask; an empty mask
    gives NaN, as in the reference."""
    h, w = mask.shape
    m = mask.to(torch.float32)
    n = m.sum()
    r = (m.sum(dim=1) * torch.arange(h, device=m.device, dtype=torch.float32)).sum() / n / h
    c = (m.sum(dim=0) * torch.arange(w, device=m.device, dtype=torch.float32)).sum() / n / w
    return torch.stack([r, c])


def _linspace_index(n_src: int, n_dst: int, device=None) -> torch.Tensor:
    """int(linspace(0, n_src - 1, n_dst)) as the JAX package computes it in
    float32: XLA turns the division by n_dst - 1 into a product with its
    rounded reciprocal and reassociates, so entry k is
    fl(k * fl((n_src - 1) * fl(1 / (n_dst - 1)))), the last n_src - 1."""
    if n_dst == 1:
        return torch.zeros(1, dtype=torch.int64, device=device)
    f32 = torch.float32
    recip = torch.tensor(1.0, dtype=f32) / torch.tensor(float(n_dst - 1), dtype=f32)
    step = torch.tensor(float(n_src - 1), dtype=f32) * recip
    idx = (torch.arange(n_dst - 1, dtype=f32) * step).to(torch.int64)
    return torch.cat([idx, torch.tensor([n_src - 1])]).to(device)


def labels_downscale(labels: torch.Tensor, new_dim) -> torch.Tensor:
    """Nearest-index label downscale by the reference's law: linspace(0, H-1,
    NH) truncated to int (see :func:`_linspace_index`)."""
    h, w = labels.shape
    nh, nw = new_dim
    r = _linspace_index(h, nh, labels.device)
    c = _linspace_index(w, nw, labels.device)
    return labels[r[:, None], c[None, :]]


def cosine_dists(feats1: torch.Tensor, feats2: torch.Tensor) -> torch.Tensor:
    """[N1, C] x [N2, C] -> [N1, N2] cosine distances."""
    f1 = feats1 / torch.linalg.vector_norm(feats1, dim=1, keepdim=True)
    f2 = feats2 / torch.linalg.vector_norm(feats2, dim=1, keepdim=True)
    return 1.0 - f1 @ f2.T


def _interpolate_nearest(img: torch.Tensor, size) -> torch.Tensor:
    """torch's F.interpolate(mode='nearest') law, src = floor(dst * H / NH),
    in float32 as the JAX package computes it."""
    h, w = img.shape
    nh, nw = size
    f32 = torch.float32
    r = torch.floor(torch.arange(nh, dtype=f32) * torch.tensor(h / nh, dtype=f32))
    c = torch.floor(torch.arange(nw, dtype=f32) * torch.tensor(w / nw, dtype=f32))
    r, c = r.to(torch.int64).to(img.device), c.to(torch.int64).to(img.device)
    return img[r[:, None], c[None, :]]


FeatDict = Dict[str, torch.Tensor]


class StyleLoss:
    def __init__(self, keys: List[str]):
        self.keys = keys


class GramStyleLoss(StyleLoss):
    """Gram-matrix MSE."""

    @staticmethod
    def _gram(feats: torch.Tensor) -> torch.Tensor:
        n, c, h, w = feats.shape
        f = feats.reshape(n, c, h * w).to(torch.float32)
        return torch.einsum("nch,ndh->ncd", f, f) / (h * w)

    def __call__(self, feats1: FeatDict, feats2: FeatDict, *_args) -> torch.Tensor:
        return torch.stack([torch.mean((self._gram(feats1[k]) - self._gram(feats2[k])) ** 2)
                            for k in self.keys]).sum()


class AdaINStyleLoss(StyleLoss):
    """Feature mean/std matching."""

    def __call__(self, feats1: FeatDict, feats2: FeatDict, *_args) -> torch.Tensor:
        total = 0.0
        for k in self.keys:
            f1, f2 = feats1[k].to(torch.float32), feats2[k].to(torch.float32)
            m1, m2 = f1.mean(dim=(-2, -1)), f2.mean(dim=(-2, -1))
            s1 = torch.sqrt(f1.var(dim=(-2, -1), correction=1))
            s2 = torch.sqrt(f2.var(dim=(-2, -1), correction=1))
            total = total + torch.mean((m1 - m2) ** 2) + torch.mean((s1 - s2) ** 2)
        return total


class NNFMStyleLoss(StyleLoss):
    """Nearest-neighbour feature matching."""

    def __call__(self, feats1: FeatDict, feats2: FeatDict, *_args) -> torch.Tensor:
        total = 0.0
        for k in self.keys:
            f1 = feats1[k][0].reshape(feats1[k].shape[1], -1)  # [C, HW]
            f2 = feats2[k][0].reshape(feats2[k].shape[1], -1)
            f1h = f1 / torch.linalg.vector_norm(f1, dim=0)
            f2h = f2 / torch.linalg.vector_norm(f2, dim=0)
            total = total + torch.mean(torch.amin(1.0 - f1h.T @ f2h, dim=1))
        return total


class SemanticStyleLoss(StyleLoss):
    """Segment-matched nearest-neighbour feature loss, the paper's
    contribution.

    ``init_feats`` caches the style features with their per-cluster means and
    centroids; the first call (or ``update_matching``) computes the Hungarian
    class-to-cluster matching; every call takes, for each pixel of the
    render's features, the cosine distance to the nearest style pixel of the
    cluster its class is matched to, and averages them.
    """

    def __init__(self, keys: List[str], clusters_path: Optional[Path] = None,
                 matching: Optional[List[int]] = None):
        super().__init__(keys)
        self.ready = False
        self.clusters: Optional[torch.Tensor] = None
        self.matching: Optional[np.ndarray] = None
        self.use_matching = False
        self.style_feats: Optional[torch.Tensor] = None
        if clusters_path is not None:
            self.use_matching = True
            seg = np.load(str(clusters_path))["seg_map"]
            ids = np.unique(seg)
            if ids[0] < 0:
                ids = ids[1:]
            self.n_clusters = len(ids)
            if not np.array_equal(np.arange(self.n_clusters), ids):
                raise ValueError("style cluster ids must be contiguous from 0")
            self.clusters = torch.from_numpy(np.asarray(seg))
            self.matching = None if matching is None else np.asarray(matching)

    def init_feats(self, all_style_feats: FeatDict, num_classes: int) -> None:
        style_feats = all_style_feats[self.keys[0]][0]  # [C, h, w]
        self.style_feats = style_feats
        if not self.use_matching:
            self.ready = True
            return
        fh, fw = style_feats.shape[1:]
        clusters_small = _interpolate_nearest(self.clusters.to(torch.float32), (fh, fw))
        self.clusters = clusters_small.to(torch.int64).to(style_feats.device)
        self.style_feats_mean = torch.stack([
            torch.where(self.clusters[None] == i, style_feats, 0.0).sum(dim=(1, 2))
            / max(int((self.clusters == i).sum()), 1)
            for i in range(self.n_clusters)
        ])
        self.style_centroids = torch.stack(
            [compute_centroid(self.clusters == i) for i in range(self.n_clusters)])
        self.num_classes = num_classes
        self.ready = True

    def update_matching(self, image_feats: torch.Tensor, preds: torch.Tensor) -> None:
        """Hungarian assignment of render classes to style clusters on the
        cosine distance of their mean features plus the distance of their
        centroids; once a run.  A cluster with no pixel at feature resolution
        is never assigned (every pixel of its class would find no match)."""
        image_feats = image_feats.detach()
        fh, fw = image_feats.shape[1:]
        preds_small = labels_downscale(preds, (fh, fw))
        image_mean = torch.stack([
            torch.where(preds_small[None] == i, image_feats, 0.0).sum(dim=(1, 2))
            / max(int((preds_small == i).sum()), 1)
            for i in range(self.num_classes)
        ])
        image_centroids = torch.stack(
            [compute_centroid(preds == i) for i in range(self.num_classes)])
        feat_d = cosine_dists(image_mean, self.style_feats_mean)
        patch_d = torch.linalg.vector_norm(
            image_centroids[:, None] - self.style_centroids[None], dim=-1)
        cost = np.nan_to_num((feat_d + patch_d).cpu().numpy())
        present = np.array([bool((self.clusters == i).any()) for i in range(self.n_clusters)])
        cost[:, ~present] = 1e9
        matching = linear_sum_assignment(cost)[1]
        if present.any():
            # A square assignment uses every column: a class that still landed
            # on an absent cluster goes to its cheapest present one.
            masked = np.where(present[None, :], cost, np.inf)
            for i in np.flatnonzero(~present[matching]):
                matching[i] = int(np.argmin(masked[i]))
        self.matching = matching

    def __call__(self, feats1: FeatDict, _feats2: Optional[FeatDict], preds: torch.Tensor,
                 _iteration: int = 0) -> torch.Tensor:
        if not self.ready:
            raise RuntimeError("call init_feats first")
        image_feat = feats1[self.keys[0]][0]  # [C, h, w]
        if self.use_matching and self.matching is None:
            self.update_matching(image_feat, preds)
        fh, fw = image_feat.shape[1:]
        preds_small = labels_downscale(preds, (fh, fw))
        img_nc = image_feat.reshape(image_feat.shape[0], -1).T  # [hw, C]
        sty_nc = self.style_feats.reshape(self.style_feats.shape[0], -1).T
        dists = cosine_dists(img_nc, sty_nc)  # [hw_img, hw_sty]
        if self.use_matching:
            # Pixel p may only match style pixels of cluster matching[preds[p]].
            match = torch.as_tensor(self.matching, device=dists.device)[preds_small.reshape(-1)]
            allowed = self.clusters.reshape(-1)[None, :] == match[:, None]
            dists = torch.where(allowed, dists, torch.inf)
        mins = torch.amin(dists, dim=1)
        # A pixel with no allowed style pixel (a user-supplied matching onto
        # an absent cluster) adds 0 instead of inf.
        finite = torch.isfinite(mins)
        return torch.where(finite, mins, 0.0).sum() / torch.clamp(finite.sum(), min=1)


class MattingLaplacian:
    """Closed-form matting Laplacian photorealism loss, as a sum over 3x3
    windows of per-window quadratic forms (batched dense products, no sparse
    matrix)."""

    def __init__(self, win_rad: int = 1, eps: float = 1e-7):
        self.win_rad = win_rad
        self.eps = eps

    def __call__(self, target: torch.Tensor, style_map: torch.Tensor) -> torch.Tensor:
        """target: [3, H, W] guide image; style_map: [3, H, W] stylized image."""
        dtype = torch.float64 if target.dtype == torch.float64 else torch.float32
        target, style_map = target.to(dtype), style_map.to(dtype)
        d, h, w = target.shape
        diam = 2 * self.win_rad + 1
        k2 = diam * diam
        ph, pw = h - diam + 1, w - diam + 1
        inds = torch.arange(h * w, device=target.device).reshape(h, w)
        win = torch.stack([inds[dy:dy + ph, dx:dx + pw] for dy in range(diam)
                           for dx in range(diam)], dim=-1).reshape(-1, k2)
        img = target.reshape(d, -1).T  # [HW, 3]
        win_i = img[win]  # [P, k^2, 3]
        mu = win_i.mean(dim=1, keepdim=True)
        var = (torch.einsum("pki,pkj->pij", win_i, win_i) / k2
               - torch.einsum("pki,pkj->pij", mu, mu))
        eye3 = torch.eye(3, dtype=dtype, device=target.device)
        inv = torch.linalg.inv(var + (self.eps / k2) * eye3)
        centered = win_i - mu
        x = torch.einsum("pki,pij->pkj", centered, inv)
        vals = torch.eye(k2, dtype=dtype, device=target.device) - (1.0 / k2) * (
            1.0 + torch.einsum("pki,pji->pkj", x, centered))
        v_w = style_map.reshape(3, -1).T[win]  # [P, k^2, 3]
        return torch.einsum("pkc,pkj,pjc->", v_w, vals, v_w)


def get_style_loss(loss_name: str, keys: Union[List[str], str], **kwargs) -> StyleLoss:
    """Name-based factory."""
    registry = {
        "GramStyleLoss": GramStyleLoss,
        "AdaINStyleLoss": AdaINStyleLoss,
        "NNFMStyleLoss": NNFMStyleLoss,
        "SemanticStyleLoss": SemanticStyleLoss,
    }
    return registry[loss_name]([keys] if isinstance(keys, str) else keys, **kwargs)
