"""Dataset factory (counterpart of ``nerfstyle_tpu/data/__init__.py``):
``cfg.type`` picks the loader, ``LLFF``, ``Replica`` or ``Synthetic``."""

from __future__ import annotations

from typing import Optional

from ..config import DatasetConfig
from ..core.types import DatasetSplit


def get_dataset(cfg: DatasetConfig, split: DatasetSplit, max_count: Optional[int] = None):
    kind = cfg.type.lower()
    if kind == "llff":
        from .llff import LLFFDataset

        return LLFFDataset(cfg, split, max_count)
    if kind == "replica":
        from .replica import ReplicaDataset

        return ReplicaDataset(cfg, split, max_count)
    if kind == "synthetic":
        from .synthetic import SyntheticDataset

        return SyntheticDataset(cfg, split, max_count)
    raise ValueError(f'Unknown dataset type "{cfg.type}"')
