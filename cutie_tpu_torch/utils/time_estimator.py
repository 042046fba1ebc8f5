"""Training ETA estimation (window average and EMA).

The port's copy of cutie_tpu/utils/time_estimator.py (reference
cutie/utils/time_estimator.py:4-43).
"""
from __future__ import annotations

import time


class TimeEstimator:
    def __init__(self, total_iter: int, step_size: int, ema_alpha: float = 0.7):
        self.avg_time_window = []
        self.exp_avg_time = None
        self.alpha = ema_alpha
        self.last_time = time.time()
        self.total_iter = total_iter
        self.step_size = step_size
        self._buffering_exp = True

    def update(self):
        curr_time = time.time()
        time_per_iter = (curr_time - self.last_time) / self.step_size
        self.last_time = curr_time
        self.avg_time_window.append(time_per_iter)
        if self._buffering_exp:
            if self.exp_avg_time is not None:
                # the first interval (warm-up) is discarded
                self._buffering_exp = False
            self.exp_avg_time = time_per_iter
        else:
            self.exp_avg_time = (self.alpha * self.exp_avg_time
                                 + (1 - self.alpha) * time_per_iter)

    def get_est_remaining(self, it: int) -> float:
        if self.exp_avg_time is None:
            return 0
        return (self.total_iter - it) * self.exp_avg_time

    def get_and_reset_avg_time(self) -> float:
        if not self.avg_time_window:
            return 0.0
        avg = sum(self.avg_time_window) / len(self.avg_time_window)
        self.avg_time_window = []
        return avg
