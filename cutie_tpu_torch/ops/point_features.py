"""PointRend-style point sampling for the training losses.

The port's counterpart of cutie_tpu/ops/point_features.py (reference
cutie/utils/point_features.py:20-111, from detectron2). Maps are channels
first [N, C, H, W]; point coordinates are [N, P, 2] as (x, y) in [0, 1].

cutie_tpu restructures the sampler for XLA (a separable matmul with a custom
backward, composed upsample weights, one-hot contractions over the class
map). Here each function is the computation those restructurings equal:
F.grid_sample (zero padding, align_corners=False), whose backward autograd
gives; a sample of F.interpolate's 4x bilinear upsample; a sample of the
one-hot class map.

Drawing the random coordinates (draw_point_candidates) is kept apart from
choosing among them (pick_uncertain_points), so that the same candidates
can be fed to both packages.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def point_sample(input_map: torch.Tensor, point_coords: torch.Tensor
                 ) -> torch.Tensor:
    """Bilinear sample of [0, 1]^2 points with zero padding.
    input_map [N, C, H, W]; point_coords [N, P, 2] -> [N, C, P]."""
    grid = 2.0 * point_coords[:, :, None, :] - 1.0
    return F.grid_sample(input_map, grid.to(input_map.dtype),
                         align_corners=False)[..., 0]


def point_sample_upsampled(low_map: torch.Tensor, point_coords: torch.Tensor,
                           factor: int) -> torch.Tensor:
    """point_sample of the factor-x bilinear upsample of low_map
    (F.interpolate, align_corners=False): the reference upsamples the
    stride-4 logits (cutie/model/cutie.py:200) and samples the result
    (losses.py:54). low_map [N, C, h, w] -> [N, C, P]."""
    if factor > 1:
        low_map = F.interpolate(low_map, scale_factor=factor, mode="bilinear",
                                align_corners=False)
    return point_sample(low_map, point_coords)


def point_sample_cls_onehot(cls_map: torch.Tensor, point_coords: torch.Tensor,
                            num_classes: int) -> torch.Tensor:
    """point_sample of the one-hot of an integer class map (the reference's
    cls_to_one_hot + point_sample, losses.py:53,75): cls_map [N, H, W] ->
    [N, num_classes, P] fp32."""
    onehot = F.one_hot(cls_map.long(), num_classes).permute(0, 3, 1, 2)
    return point_sample(onehot.float(), point_coords.float())


def calculate_uncertainty(sem_seg_logits: torch.Tensor) -> torch.Tensor:
    """-(top1 - top2) logit margin (point_features.py:20-35):
    [N, C, P] -> [N, 1, P]; with two classes, -|logit of class 1|."""
    if sem_seg_logits.shape[1] == 2:
        return -sem_seg_logits[:, 1:2].abs()
    top2 = torch.topk(sem_seg_logits, 2, dim=1).values
    return top2[:, 1:2] - top2[:, 0:1]


def draw_point_candidates(generator: Optional[torch.Generator], n: int,
                          num_points: int, oversample_ratio: float,
                          importance_sample_ratio: float,
                          device: torch.device
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random coordinates of get_uncertain_point_coords_with_randomness:
    (candidates [n, num_points * oversample_ratio, 2] to choose the most
    uncertain of, random points [n, the rest of num_points, 2]), uniform in
    [0, 1) from `generator`, which lives on `device`."""
    num_sampled = int(num_points * oversample_ratio)
    num_random = num_points - int(importance_sample_ratio * num_points)
    candidates = torch.rand(n, num_sampled, 2, generator=generator,
                            device=device)
    random_points = torch.rand(n, num_random, 2, generator=generator,
                               device=device)
    return candidates, random_points


@torch.no_grad()
def pick_uncertain_points(coarse_logits: torch.Tensor, candidates: torch.Tensor,
                          random_points: torch.Tensor, num_uncertain: int,
                          uncertainty_func: Callable = calculate_uncertainty,
                          sample_fn: Callable = point_sample) -> torch.Tensor:
    """The num_uncertain most uncertain candidates (their coarse logits
    probed by sample_fn), then the random points (point_features.py:62-111).
    Returns [N, num_uncertain + R, 2]."""
    u = uncertainty_func(sample_fn(coarse_logits, candidates))[:, 0]
    k = min(num_uncertain, u.shape[-1])
    idx = torch.topk(u, k, dim=-1).indices
    picked = torch.gather(candidates, 1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([picked, random_points.to(picked.dtype)], dim=1)


def get_uncertain_point_coords_with_randomness(
        generator: Optional[torch.Generator], coarse_logits: torch.Tensor,
        uncertainty_func: Callable, num_points: int, oversample_ratio: float,
        importance_sample_ratio: float,
        sample_fn: Callable = point_sample) -> torch.Tensor:
    """(point_features.py:62-111). Returns [N, num_points, 2] in [0, 1]."""
    candidates, random_points = draw_point_candidates(
        generator, coarse_logits.shape[0], num_points, oversample_ratio,
        importance_sample_ratio, coarse_logits.device)
    return pick_uncertain_points(
        coarse_logits, candidates, random_points,
        int(importance_sample_ratio * num_points), uncertainty_func, sample_fn)
