"""Training logs: TensorBoard where it is installed, text logging always.

The port's counterpart of cutie_tpu/utils/logger.py (reference
cutie/utils/logger.py:29-107): scalars, strings and images, the git commit
stamped at creation, one writer on rank 0. Without the tensorboard package
(the card's machine has none) it logs text only.
"""
from __future__ import annotations

import datetime
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


class TensorboardLogger:
    def __init__(self, run_dir: Optional[str], *, enabled: bool = True,
                 py_logger: Optional[logging.Logger] = None):
        """enabled should be rank == 0 in a multi-process run."""
        self.py_log = py_logger or log
        self.board = None
        self.time_estimator = None
        if enabled and run_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                self.py_log.warning("TensorBoard unavailable (%s); logging "
                                    "text only", e)
            else:
                os.makedirs(run_dir, exist_ok=True)
                self.board = SummaryWriter(run_dir)
        self.log_string("creation_time", str(datetime.datetime.now()))
        self._log_git_sha()

    def _log_git_sha(self):
        try:
            sha = subprocess.check_output(
                ["git", "rev-parse", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stderr=subprocess.DEVNULL, timeout=30).decode().strip()
        except (OSError, subprocess.SubprocessError):
            sha = "unknown"
        self.log_string("git_sha", sha)

    def log_scalar(self, tag: str, x: float, it: int):
        if self.board is not None:
            self.board.add_scalar(tag, x, it)

    def log_metrics(self, prefix: str, metrics: dict, it: int):
        msg = f"{prefix} it={it}"
        for k, v in metrics.items():
            self.log_scalar(f"{prefix}/{k}", float(v), it)
            msg += f" {k}={float(v):.6f}"
        if self.time_estimator is not None:
            self.time_estimator.update()
            avg = self.time_estimator.get_and_reset_avg_time()
            est = self.time_estimator.get_est_remaining(it)
            self.log_scalar(f"{prefix}/avg_time", avg, it)
            msg += (f" avg_time={avg:.3f}s "
                    f"eta={datetime.timedelta(seconds=int(est))}")
        self.py_log.info(msg)

    def log_image(self, tag: str, image: np.ndarray, it: int):
        """image: HWC uint8."""
        if self.board is not None:
            self.board.add_image(tag, image, it, dataformats="HWC")

    def log_string(self, tag: str, x: str):
        self.py_log.info("%s - %s", tag, x)
        if self.board is not None:
            self.board.add_text(tag, x)
