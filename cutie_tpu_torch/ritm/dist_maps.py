"""Click-encoding distance maps for interactive segmentation.

The port's counterpart of cutie_tpu/ritm/dist_maps.py (reference
gui/ritm/model/ops.py:38-102), two paths:
  - a vectorised torch path (min over clicks of the squared normalised
    distance), which the model runs on its own device;
  - the host BFS of csrc_host/dist_maps.cpp (the reference's Cython kernel
    rewritten in C++), built with g++ at first use into _build/ and called
    through ctypes. A failed build or load raises.

Point layout (reference convention): [n_points, 3] rows of (row, col,
index); the first half are positive clicks, the second half negative; rows
with row < 0 are padding.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cutie_tpu_torch.utils.host_build import CSRC_HOST_DIR, host_library

SOURCE = CSRC_HOST_DIR / "dist_maps.cpp"
FAR = 1e6   # the distance of a layer with no click


@functools.cache
def library() -> ctypes.CDLL:
    lib = host_library(SOURCE)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.get_dist_maps.argtypes = [fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, fp]
    lib.get_dist_maps.restype = None
    return lib


def get_dist_maps_cpu(points: np.ndarray, height: int, width: int,
                      norm_delimiter: float) -> np.ndarray:
    """Host BFS: points [P, 3] -> [2, H, W] squared normalised distances."""
    points = np.ascontiguousarray(points, np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [P, 3], got {points.shape}")
    out = np.empty((2, height, width), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    library().get_dist_maps(points.ctypes.data_as(fp), points.shape[0], height,
                            width, ctypes.c_float(norm_delimiter),
                            out.ctypes.data_as(fp))
    return out


def get_dist_maps(points: torch.Tensor, height: int, width: int,
                  norm_delimiter: float) -> torch.Tensor:
    """Vectorised path: points [B, P, 3] -> [B, 2, H, W], per layer the min
    over its clicks of the squared normalised distance, FAR where a layer
    has no valid click."""
    b, p, _ = points.shape
    half = p // 2
    rows = torch.arange(height, dtype=torch.float32, device=points.device)
    cols = torch.arange(width, dtype=torch.float32, device=points.device)
    dy = (rows[None, None, :, None] - points[..., 0, None, None]) / norm_delimiter
    dx = (cols[None, None, None, :] - points[..., 1, None, None]) / norm_delimiter
    d2 = dy * dy + dx * dx   # [B, P, H, W]
    d2 = torch.where((points[..., 0] < 0)[..., None, None],
                     torch.full_like(d2, FAR), d2)
    far = torch.full((b, height, width), FAR, device=points.device)
    pos = d2[:, :half].amin(1) if half > 0 else far
    neg = d2[:, half:].amin(1) if p - half > 0 else far
    return torch.stack([pos, neg], 1)


def encode_clicks(coords: torch.Tensor, height: int, width: int, *,
                  norm_radius: float, spatial_scale: float = 1.0,
                  use_disks: bool = False) -> torch.Tensor:
    """DistMaps.get_coord_features (ops.py:49-99) for a batch:
    coords [B, 2K, 3] -> features [B, 2, H, W] in fp32: disks of radius
    norm_radius (use_disks), else tanh(2 * distance / norm_radius)."""
    norm = 1.0 if use_disks else norm_radius * spatial_scale
    coords = coords.float()
    scaled = torch.cat([coords[..., :2] * spatial_scale, coords[..., 2:]], -1)
    maps = get_dist_maps(scaled, height, width, norm)
    if use_disks:
        return (maps <= (norm_radius * spatial_scale) ** 2).float()
    return torch.tanh(2.0 * torch.sqrt(maps))
