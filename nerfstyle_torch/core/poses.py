"""Pose and coordinate-system utilities, host-side numpy (counterpart of
``nerfstyle_tpu/core/poses.py``, copied function for function).

Converts dataset camera and world conventions into the canonical one: an
RDF camera (x right, y down, z forward) in an RFU world (x right, y front,
z up).
"""

from __future__ import annotations

import numpy as np

CANON_CAM = "rdf"
CANON_WORLD = "rfu"

# Directional vectors in canonical representation; +X/+Y/+Z = right/front/up.
_COORD_VECTORS = {
    "r": (1, 0, 0),
    "l": (-1, 0, 0),
    "f": (0, 1, 0),
    "b": (0, -1, 0),
    "u": (0, 0, 1),
    "d": (0, 0, -1),
}


def get_canonical_coord_mtx(coord_str: str) -> np.ndarray:
    """The [3, 3] matrix whose columns are the axes of ``coord_str`` (three
    letters of r/l/f/b/u/d, right-handed) in canonical coordinates."""
    try:
        if len(coord_str) != 3:
            raise KeyError(coord_str)
        mtx = np.array([_COORD_VECTORS[c] for c in coord_str.lower()]).T
    except KeyError:
        raise ValueError(f'Invalid coordinate system "{coord_str}"') from None
    if np.linalg.det(mtx) != 1:
        raise ValueError(f'Invalid coordinate system "{coord_str}"')
    return mtx


def convert_poses(poses: np.ndarray, w_coord: str, c_coord: str) -> np.ndarray:
    """Convert [N, 4, 4] camera-to-world poses from dataset conventions
    (world ``w_coord``, camera ``c_coord``) into the canonical convention:
    R' = B R A, t' = B t."""
    can_cam = get_canonical_coord_mtx(CANON_CAM)
    dat_cam = get_canonical_coord_mtx(c_coord)
    can_world = get_canonical_coord_mtx(CANON_WORLD)
    dat_world = get_canonical_coord_mtx(w_coord)

    tf1 = can_cam.T @ dat_cam
    tf2 = dat_world.T @ can_world

    out = np.copy(poses)
    out[:, :3, :3] = tf2 @ (poses[:, :3, :3] @ tf1)
    out[:, :3, 3:4] = tf2 @ poses[:, :3, 3:4]
    return out


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean camera pose of [N, 4, 4] c2w matrices (z-forward orthonormalized)."""
    center = poses[:, :3, 3].mean(0)
    z = poses[:, :3, 2].mean(0)
    z = z / np.linalg.norm(z)
    up = poses[:, :3, 1].mean(0)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    out = np.eye(4, dtype=poses.dtype)
    out[:3, :3] = np.stack([x, y, z], axis=1)
    out[:3, 3] = center
    return out


def spiral_poses(
    base_pose: np.ndarray,
    radius: float = 0.1,
    num: int = 60,
    zrate: float = 0.5,
) -> np.ndarray:
    """Spiral camera path around a base pose, for novel-view rendering demos."""
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * 2, num, endpoint=False):
        offset = np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate)], dtype=np.float64
        ) * radius
        p = np.array(base_pose, copy=True)
        p[:3, 3] = p[:3, 3] + p[:3, :3] @ offset
        out.append(p)
    return np.stack(out).astype(base_pose.dtype)
