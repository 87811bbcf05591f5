"""Where the hot cells of a checkpoint's occupancy grid lie on the open bench
scene: inside its spheres (``data.synthetic._SPHERES``), where no ray sees
the density, or in free space::

    python tests/hot_cells.py CKPT [CKPT ...]

A cell is hot above ``psnr_room_run.HOT_FACTOR`` x ``density_thresh`` (the
checkpoint's renderer config).  One JSON line a checkpoint: its step and,
for each cascade, the hot cells and where their centres lie, by the signed
distance d to the nearest sphere's surface (one cell is the cascade's cell
width): ``inside`` (d < 0), ``surface`` (0 <= d < one cell), ``near`` (one
cell <= d <= 0.2) and ``free_space`` (d > 0.2), which add up to ``hot``;
and the occupied cells.  Reads either package's checkpoint
with the port's reader; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from nerfstyle_torch.data.synthetic import _SPHERES  # noqa: E402
from nerfstyle_torch.tools.psnr_room_run import HOT_FACTOR  # noqa: E402
from nerfstyle_torch.training.checkpoint import load_checkpoint  # noqa: E402


def hot_cells(path: Path) -> dict:
    meta, groups = load_checkpoint(path)
    grid, bound = groups["occ"][0], float(meta["renderer_static"]["bound"])
    thresh = float(meta["render_cfg"]["density_thresh"])
    mean = float(groups["occ"][2])
    h = round(grid.shape[1] ** (1 / 3))
    out = {"ckpt": str(path), "step": meta["iter_ctr"], "mean_density": mean, "cascades": []}
    for cas, row in enumerate(grid):
        hot = np.nonzero(row > HOT_FACTOR * thresh)[0]
        cas_bound = min(2.0**cas, bound)
        half = cas_bound / h  # half a cell
        coords = np.stack([hot // (h * h), (hot // h) % h, hot % h], axis=-1)
        xyz = (2.0 * coords / (h - 1) - 1.0) * (cas_bound - half)
        # Signed distance to the nearest sphere's surface (< 0 inside).
        d = (np.linalg.norm(xyz[:, None] - _SPHERES[None, :, :3], axis=-1)
             - _SPHERES[None, :, 3]).min(axis=1) if len(hot) else np.zeros(0)
        out["cascades"].append({
            "hot": int(len(hot)), "inside": int((d < 0).sum()),
            "surface": int(((d >= 0) & (d < 2 * half)).sum()),
            "near": int(((d >= 2 * half) & (d <= 0.2)).sum()),
            "free_space": int((d > 0.2).sum()),
            "occupied": int((row > min(mean, thresh)).sum())})
    return out


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        print(json.dumps(hot_cells(Path(arg))), flush=True)
