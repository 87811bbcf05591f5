"""Procedural synthetic scene dataset (counterpart of
``nerfstyle_tpu/data/synthetic.py``, same scene, same cache format and
``SCENE_FORMAT_VERSION``, so both packages share one cached scene).

A self-contained Lambertian sphere scene with per-sphere segmentation
classes: K colored spheres inside the bound, rendered by direct ray tracing
(host-side numpy, cached to disk), cameras on a circle looking at the origin.
:func:`write_llff_layout` and :func:`write_replica_layout` write a cached
scene in the file layouts of the LLFF and Replica loaders, which then load
it with no download.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import DatasetConfig
from ..core.types import BBox, DatasetSplit, Intrinsics
from .base import BaseDataset

_SPHERES = np.array(
    [
        # cx, cy, cz, radius
        [0.0, 0.0, 0.0, 0.45],
        [0.7, 0.3, -0.2, 0.3],
        [-0.6, -0.4, 0.3, 0.35],
    ],
    dtype=np.float32,
)
_COLORS = np.array(
    [[0.9, 0.2, 0.2], [0.2, 0.8, 0.3], [0.25, 0.35, 0.9]], dtype=np.float32
)
_LIGHT = np.array([0.5, -0.7, 0.6], dtype=np.float32)

# Enclosed-room variant: an axis-aligned box around the spheres with the
# cameras INSIDE.  The open sphere scene leaves most rays unterminated (they
# exit into white background with transmittance ~1), which is unlike the
# reference's headline benchmark (LLFF *room*: enclosed, every ray ends on a
# wall, raymarching.cu's T<1e-4 early-out kills the tail).  The room gives
# every pixel real geometry: early termination saturates, occupancy stays a
# thin 2D shell, and few-view fog has nothing ambiguous to grow in.
#
# The walls COINCIDE with the scene AABB (bound 2.0 in cfgs + bench): volume
# the training rays can never see keeps its init-level density forever — it
# cannot receive gradient (T == 0 behind an opaque wall) and the occupancy
# sweep keeps re-measuring the same density — so any exterior margin becomes
# permanently-occupied fog that every ray must march through.  Measured with
# the old inset walls (1.8/1.5 in a bound-2.0 box, 39% exterior volume):
# occupancy plateaued at ~26% and demand at ~300 samples/ray after 1.6k
# iters.  A user sets `bound` to fit the scene; the generator now does too.
_ROOM_EXT = np.array([2.0, 2.0, 2.0], dtype=np.float32)  # half-extents

# Bumped whenever the generated geometry changes: generate_scene() embeds it
# in meta.npz and regenerates any cached scene with a different version, so
# stale scene caches can never silently feed a bench.
SCENE_FORMAT_VERSION = 2
_WALL_COLORS = np.array(
    [
        [0.85, 0.55, 0.45],  # +x
        [0.45, 0.65, 0.85],  # -x
        [0.80, 0.80, 0.55],  # +y
        [0.60, 0.80, 0.60],  # -y
        [0.75, 0.70, 0.65],  # +z (ceiling)
        [0.55, 0.50, 0.48],  # -z (floor)
    ],
    dtype=np.float32,
)


def _look_at(eye: np.ndarray) -> np.ndarray:
    """c2w pose with camera at ``eye`` looking at origin; camera frame is
    X-right, Y-down, Z-forward (flip_camera=0 convention)."""
    fwd = -eye / np.linalg.norm(eye)
    world_up = np.array([0.0, 0.0, 1.0], dtype=np.float32)
    right = np.cross(fwd, world_up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, eye
    return pose


def _trace_room(origin: np.ndarray, dirs: np.ndarray):
    """Exit intersection of rays (origin inside the box) with the room walls.

    Returns (t [N], rgb [N, 3]): hit distance and checker-shaded wall color.
    The origin is inside a convex box, so every ray exits through exactly one
    face — the slab-method exit distance.
    """
    light = _LIGHT / np.linalg.norm(_LIGHT)
    safe = np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
    # Per axis, distance to the face the ray is heading toward.
    t_axis = (np.sign(safe) * _ROOM_EXT[None] - origin[None]) / safe  # [N, 3]
    axis = np.argmin(t_axis, axis=-1)
    t = np.take_along_axis(t_axis, axis[:, None], axis=-1)[:, 0]
    pt = origin[None] + t[:, None] * dirs
    heading_pos = np.take_along_axis(dirs, axis[:, None], axis=-1)[:, 0] > 0
    face = axis * 2 + np.where(heading_pos, 0, 1)  # +x,-x,+y,-y,+z,-z
    # Checker texture in the two in-plane coordinates (0.6-unit tiles).
    uv = np.stack(
        [np.take_along_axis(pt, ((axis + 1) % 3)[:, None], axis=-1)[:, 0],
         np.take_along_axis(pt, ((axis + 2) % 3)[:, None], axis=-1)[:, 0]],
        axis=-1,
    )
    checker = (np.floor(uv[:, 0] / 0.6) + np.floor(uv[:, 1] / 0.6)) % 2
    shade = np.where(checker > 0.5, 1.0, 0.72)
    # Inward-facing normal = -sign(dir_axis) on that axis.
    normal = np.zeros_like(dirs)
    np.put_along_axis(
        normal, axis[:, None], np.where(heading_pos, -1.0, 1.0)[:, None], axis=-1
    )
    lam = np.clip(np.sum(normal * light[None], axis=-1), 0.0, 1.0)
    rgb = _WALL_COLORS[face] * (shade * (0.45 + 0.55 * lam))[:, None]
    return t.astype(np.float32), rgb.astype(np.float32)


def _trace(origin: np.ndarray, dirs: np.ndarray, room: bool = False):
    """Ray-trace the scene: returns (rgb [N, 3], seg [N]).

    ``room=False``: K spheres on a white background (open scene).
    ``room=True``: the spheres inside an enclosed checker-walled box — every
    ray terminates on geometry (walls are seg class 0).
    """
    n = dirs.shape[0]
    if room:
        best_t, rgb = _trace_room(origin, dirs)
        # Smaller spheres in the room: keeps wall/depth variety in view even
        # with the camera orbit inside the box.
        spheres = _SPHERES * np.array([1, 1, 1, 0.7], dtype=np.float32)
    else:
        rgb = np.ones((n, 3), np.float32)  # white background
        best_t = np.full(n, np.inf, np.float32)
        spheres = _SPHERES
    seg = np.zeros(n, np.float32)  # class 0 = background / walls
    light = _LIGHT / np.linalg.norm(_LIGHT)
    for i, (sph, color) in enumerate(zip(spheres, _COLORS)):
        oc = origin[None] - sph[:3]
        b = np.sum(dirs * oc, axis=-1)
        c = np.sum(oc * oc, axis=-1) - sph[3] ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.where(hit, disc, 0.0))
        hit &= (t > 1e-3) & (t < best_t)
        pt = origin[None] + t[:, None] * dirs
        normal = (pt - sph[:3]) / sph[3]
        lam = np.clip(np.sum(normal * light, axis=-1), 0.0, 1.0)
        shade = (0.35 + 0.65 * lam)[:, None] * color[None]
        rgb[hit] = shade[hit]
        seg[hit] = i + 1
        best_t[hit] = t[hit]
    return rgb, seg


def generate_scene(
    root: Path,
    num_train: int = 24,
    num_test: int = 6,
    h: int = 96,
    w: int = 128,
    cam_radius: Optional[float] = None,
    room: bool = False,
) -> None:
    """Render and cache the scene to ``root`` (idempotent).

    ``room=True`` encloses the spheres in a checker-walled box and places the
    camera orbit INSIDE it (see ``_trace``) — the representative benchmark
    regime (reference headline scene: LLFF room, enclosed).
    """
    root = Path(root)
    meta_path = root / "meta.npz"
    if meta_path.exists():
        try:
            cached = int(np.load(meta_path).get("scene_version", 1))
        except Exception:
            cached = 0
        if cached == SCENE_FORMAT_VERSION:
            return
    root.mkdir(parents=True, exist_ok=True)
    if cam_radius is None:
        cam_radius = 1.55 if room else 2.8

    fx = fy = 0.9 * w
    cx, cy = w / 2.0, h / 2.0
    xs = (np.arange(w, dtype=np.float32) + 0.5 - cx) / fx
    ys = (np.arange(h, dtype=np.float32) + 0.5 - cy) / fy
    gx, gy = np.meshgrid(xs, ys)
    cam_dirs = np.stack([gx, gy, np.ones_like(gx)], axis=-1).reshape(-1, 3)

    def render_split(count: int, phase: float):
        poses, images, segs = [], [], []
        for i in range(count):
            theta = 2 * np.pi * i / count + phase
            z = (0.55 + 0.3 * np.sin(3 * theta)) if room else (
                0.9 + 0.35 * np.sin(3 * theta))
            eye = np.array(
                [cam_radius * np.cos(theta), cam_radius * np.sin(theta), z],
                dtype=np.float32,
            )
            pose = _look_at(eye)
            world_dirs = cam_dirs @ pose[:3, :3].T
            norm_dirs = world_dirs / np.linalg.norm(world_dirs, axis=-1, keepdims=True)
            rgb, seg = _trace(pose[:3, 3], norm_dirs, room=room)
            poses.append(pose)
            images.append(rgb.reshape(h, w, 3))
            segs.append(seg.reshape(h, w))
        return np.stack(poses), np.stack(images), np.stack(segs)

    tr_poses, tr_images, tr_segs = render_split(num_train, 0.0)
    te_poses, te_images, te_segs = render_split(num_test, 0.13)

    np.savez_compressed(
        root / "meta.npz",
        h=h, w=w, fx=fx, fy=fy, cx=cx, cy=cy,
        train_poses=tr_poses, test_poses=te_poses,
        scene_version=SCENE_FORMAT_VERSION,
    )
    np.savez_compressed(root / "train_images.npz", images=tr_images, segs=tr_segs)
    np.savez_compressed(root / "test_images.npz", images=te_images, segs=te_segs)


# Camera y and z negated: LLFF poses are x-right, y-up, z-backward cameras,
# which cfgs/renderer/llff.yaml's flip_camera 3 turns back.
_LLFF_CAM_FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def write_llff_layout(scene: Path, root: Path, scale: float = 1.0) -> np.ndarray:
    """Write the cached scene ``scene`` (:func:`generate_scene`) as an LLFF
    layout under ``root`` (``data/llff.py``): the train views as
    ``images_8/image<i>.png`` with ``seg/image<i>_seg.npz``, and
    ``transforms_train.json`` and ``transforms_test.json``, the test split
    as poses only.  Translations are divided by ``scale``, the data config's
    ``scale`` to give back the scene's size, and each camera's y and z axes
    are negated (LLFF's convention).  Returns the test views' images
    [N, H, W, 3], which the layout withholds."""
    from .. import utils

    scene, root = Path(scene), Path(root)
    meta = np.load(scene / "meta.npz")
    train = np.load(scene / "train_images.npz")
    intr = {"h": int(meta["h"]), "w": int(meta["w"]), "fl_x": float(meta["fx"]),
            "fl_y": float(meta["fy"]), "cx": float(meta["cx"]), "cy": float(meta["cy"])}

    def llff_pose(pose: np.ndarray) -> list:
        out = pose @ _LLFF_CAM_FLIP
        out[:3, 3] /= scale
        return out.tolist()

    (root / "images_8").mkdir(parents=True, exist_ok=True)
    (root / "seg").mkdir(exist_ok=True)
    frames = []
    for i, (pose, img, seg) in enumerate(zip(meta["train_poses"], train["images"], train["segs"])):
        fn = f"image{i:03d}"
        utils.save_image(img, root / "images_8" / f"{fn}.png")
        np.savez(root / "seg" / f"{fn}_seg.npz", seg_map=seg.astype(np.int64))
        frames.append({"file_path": f"images_8/{fn}.png", "transform_matrix": llff_pose(pose)})
    (root / "transforms_train.json").write_text(json.dumps({**intr, "frames": frames}))
    test = [{"transform_matrix": llff_pose(p)} for p in meta["test_poses"]]
    (root / "transforms_test.json").write_text(json.dumps({**intr, "frames": test}))
    return np.load(scene / "test_images.npz")["images"]


def write_replica_layout(scene: Path, root: Path, name: str = "synthetic",
                         traj: int = 0) -> float:
    """Write the train views of the cached scene ``scene`` as one Replica
    trajectory (``data/replica.py``):
    ``<root>/<name>/Sequence_<traj>/rgb/rgb_<i>.png``, ``traj_w_c.txt`` (the
    poses as they are: RDF cameras in an RFU world, Replica's convention)
    and ``<root>/seg/rgb_<i>_seg.npz``.  Returns the focal ratio
    (fx / max(w, h)) for the data config's ``replica_cfg``."""
    from .. import utils

    scene, root = Path(scene), Path(root)
    meta = np.load(scene / "meta.npz")
    train = np.load(scene / "train_images.npz")
    seq = root / name / f"Sequence_{traj}"
    (seq / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "seg").mkdir(exist_ok=True)
    for i, (img, seg) in enumerate(zip(train["images"], train["segs"])):
        utils.save_image(img, seq / "rgb" / f"rgb_{i}.png")
        np.savez(root / "seg" / f"rgb_{i}_seg.npz", seg_map=seg.astype(np.int64))
    np.savetxt(seq / "traj_w_c.txt", meta["train_poses"].reshape(-1, 16))
    return float(meta["fx"]) / max(int(meta["w"]), int(meta["h"]))


class SyntheticDataset(BaseDataset):
    """Array-backed dataset with the BaseDataset interface."""

    def __init__(
        self,
        cfg: DatasetConfig,
        split: DatasetSplit,
        max_count: Optional[int] = None,
    ):
        self.cfg = cfg
        self.split = split
        self.max_count = max_count

        root = Path(cfg.root_path)
        generate_scene(root)
        meta = np.load(root / "meta.npz")
        split_name = "train" if split == DatasetSplit.TRAIN else "test"
        data = np.load(root / f"{split_name}_images.npz")

        self.poses = meta[f"{split_name}_poses"].astype(np.float32)
        self.poses[:, :3, 3] *= cfg.scale
        self.images = np.moveaxis(data["images"].astype(np.float32), -1, 1)
        self.has_gt = True
        self.fns = [f"frame_{i:03d}" for i in range(len(self.poses))]

        self.seg_groups, self.num_classes = None, 0
        if split == DatasetSplit.TRAIN:
            self.seg_groups = data["segs"].astype(np.float32)
            self.num_classes = len(np.unique(self.seg_groups))

        if max_count is not None and max_count < len(self.poses):
            ids = np.round(np.linspace(0, len(self.poses), max_count + 1)[:-1]).astype(int)
            self.fns = [self.fns[i] for i in ids]
            self.poses = self.poses[ids]
            self.images = self.images[ids]
            if self.seg_groups is not None:
                self.seg_groups = self.seg_groups[ids]

        self.intr = Intrinsics(
            h=int(meta["h"]), w=int(meta["w"]),
            fx=float(meta["fx"]), fy=float(meta["fy"]),
            cx=float(meta["cx"]), cy=float(meta["cy"]),
        )
        self.bbox = BBox.from_radius(cfg.bound)
