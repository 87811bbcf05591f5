"""Core types and camera rays of the port."""

from .types import BBox, Box2D, DatasetCoordSystem, DatasetSplit, Intrinsics, RayBundle

__all__ = [
    "BBox",
    "Box2D",
    "DatasetCoordSystem",
    "DatasetSplit",
    "Intrinsics",
    "RayBundle",
]
