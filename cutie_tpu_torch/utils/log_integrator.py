"""Metric accumulation with a cross-rank average.

The port's counterpart of cutie_tpu/utils/log_integrator.py (reference
cutie/utils/log_integrator.py:11-84): accumulate loss dicts, average them,
run the hooks, and log on rank 0. Values are averaged across ranks with
torch.distributed only when a process group is initialised.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Union

import numpy as np
import torch
import torch.distributed as dist

TensorOrFloat = Union[float, np.ndarray, torch.Tensor]


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


class Integrator:
    def __init__(self, logger, *, distributed: bool = True):
        self.values: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.hooks: List[Callable] = []
        self.logger = logger
        self.distributed = distributed

    def add_dict(self, tensor_dict: Dict[str, TensorOrFloat]) -> None:
        for k, v in tensor_dict.items():
            v = float(v.item() if torch.is_tensor(v) else np.asarray(v))
            if k not in self.values:
                self.values[k] = v
                self.counts[k] = 1
            else:
                self.values[k] += v
                self.counts[k] += 1

    def add_hook(self, hook: Callable) -> None:
        """hook(values) -> (name, value), computed at finalize time."""
        self.hooks.append(hook)

    def reset_except_hooks(self) -> None:
        self.values = {}
        self.counts = {}

    def finalize(self, prefix: str, it: int) -> None:
        for hook in self.hooks:
            k, v = hook(self.values)
            self.add_dict({k: v})

        avged = {k: v / self.counts[k] for k, v in self.values.items()}
        rank = 0
        if self.distributed and _distributed():
            # average across ranks (reference log_integrator.py:69-84)
            keys = sorted(avged)
            vec = torch.tensor([avged[k] for k in keys], dtype=torch.float64)
            if dist.get_backend() == "nccl":
                vec = vec.cuda()
            dist.all_reduce(vec)
            avged = dict(zip(keys, (vec / dist.get_world_size()).tolist()))
            rank = dist.get_rank()
        if self.logger is not None and rank == 0:
            self.logger.log_metrics(prefix, avged, it)
