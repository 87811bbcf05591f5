"""Dataset factory (counterpart of ``nerfstyle_tpu/data/__init__.py``).

Only the procedural ``Synthetic`` scene is ported so far; the LLFF and
Replica loaders are listed in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

from ..config import DatasetConfig
from ..core.types import DatasetSplit


def get_dataset(cfg: DatasetConfig, split: DatasetSplit, max_count: Optional[int] = None):
    kind = cfg.type.lower()
    if kind == "synthetic":
        from .synthetic import SyntheticDataset

        return SyntheticDataset(cfg, split, max_count)
    if kind in ("llff", "replica"):
        raise NotImplementedError(f'the "{cfg.type}" loader is not ported yet')
    raise ValueError(f'Unknown dataset type "{cfg.type}"')
