"""Propagation frame reader for the GUI (threaded prefetch): the port's
counterpart of cutie_tpu/gui/reader.py, over data/prefetch.py.

Behavioral parity target: reference gui/reader.py:10-62 (PropagationReader:
streams frames forward/backward from the current index).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from cutie_tpu_torch.data.prefetch import prefetch_iter
from cutie_tpu_torch.gui.resource_manager import ResourceManager


class PropagationReader:
    def __init__(self, res_man: ResourceManager, start_ti: int,
                 direction: str):
        self.res_man = res_man
        self.start_ti = start_ti
        if direction == "forward":
            self.indices = list(range(start_ti + 1, res_man.T))
        elif direction == "backward":
            self.indices = list(range(start_ti - 1, -1, -1))
        else:
            raise ValueError(f"direction is 'forward' or 'backward', not {direction!r}")

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        ti = self.indices[i]
        return self.res_man.get_image(ti), ti

    def __len__(self):
        return len(self.indices)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        return prefetch_iter(self, num_workers=2, depth=4)
