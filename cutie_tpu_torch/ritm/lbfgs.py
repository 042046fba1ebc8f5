"""L-BFGS with a zoom line search, and the f-BRS drive around it.

The port's counterpart of cutie_tpu/ritm/brs.py:device_lbfgs_drive, the
default f-BRS optimiser of cutie_tpu, and of the optimiser it builds from
optax 0.2.6:

    optax.lbfgs(memory_size=20,
                linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=8))

that is scale_by_lbfgs -> scale(-1) -> the zoom line search
(optax/_src/alias.py:2718-2730), with the line search's own defaults:
slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, stepsize_precision
1e-5, increase_factor 2, tol 0, no largest step, and initial_guess_strategy
"keep" (each line search starts from the previous one's step), which is
scale_by_zoom_linesearch's default and not lbfgs's own default line search.

  - _LBFGS (optax/_src/transform.py:1497-1780): a ring of the last 20
    (s, y) pairs with rho = 1 / <s, y>, 0 where <s, y> == 0, the first
    update's pair masked out, the two-loop recursion in optax's order
    (newest pair first, then oldest first), gamma = <s, y> / <y, y>, and
    min(1, 1 / |g|) on the first update;
  - _ZoomLinesearch (optax/_src/linesearch.py:576-1330): the interval
    search, the zoom with cubic and quadratic interpolation and their
    safeguards, the approximate-Wolfe decrease, and the safe step when the
    line search runs out of steps;
  - lbfgs_drive: device_lbfgs_drive's loop, its exits and its budget.

The vectors (x, the gradients, the directions, the 20-pair memory, the
best track) stay on the objective's device and are never read by the host.
The line search's scalars (a value and a slope a step) are read once a
line-search step, in one fetch, and its branch tests run on the host in
the vectors' dtype (numpy float32 for float32 vectors), as optax computes
them in float32 on the device: float64 arithmetic would flip some of them.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

MEMORY_SIZE = 20
MAX_LINESEARCH_STEPS = 8
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0


class HostReads:
    """Every read of the device by the drive: fetch() stacks scalars into
    one float64 tensor (exact for float32 values and for counts below
    2^53) and reads it once."""

    def __init__(self):
        self.count = 0

    def fetch(self, *scalars: torch.Tensor):
        self.count += 1
        return torch.stack([s.reshape(()).double() for s in scalars]).tolist()


def value_and_grad(objective, x: torch.Tensor):
    """objective(x) -> (value, aux) at x, with d value / d x by autograd.
    -> (value, grad, aux), all detached."""
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        value, aux = objective(x)
        grad, = torch.autograd.grad(value, x)
    return value.detach(), grad, tuple(a.detach() for a in aux)


class _LBFGS:
    """optax.scale_by_lbfgs(memory_size, scale_init_precond=True) followed
    by scale(-1): direction(grad, x) is -P grad, P the inverse-Hessian
    approximation of the pairs seen so far."""

    def __init__(self, x0: torch.Tensor, memory_size: int = MEMORY_SIZE):
        n = x0.numel()
        self.m = memory_size
        self.count = 0
        self.params = torch.zeros_like(x0)
        self.updates = torch.zeros_like(x0)
        self.s = x0.new_zeros((memory_size, n))
        self.y = x0.new_zeros((memory_size, n))
        self.rho = x0.new_zeros((memory_size,))

    def direction(self, grad: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        m, count = self.m, self.count
        if count > 0:
            s, y = params - self.params, grad - self.updates
            sy = torch.dot(y, s)
            slot = (count - 1) % m
            self.s[slot], self.y[slot] = s, y
            self.rho[slot] = torch.where(sy == 0, torch.zeros_like(sy), 1.0 / sy)
            yy = y.square().sum()
            gamma = torch.where(yy > 0, sy / yy, torch.ones_like(sy))
        else:
            # the first update: its pair is masked out (zero, as the memory
            # starts), and the scale is a capped reciprocal of |g|
            gamma = torch.clamp(1.0 / grad.square().sum().sqrt(), max=1.0)
        # The pairs of updates 1..count sit in slots 0..count-1 (mod m); a
        # zero slot leaves the vector as it is (alpha = beta = 0), so only
        # the written ones are visited, newest first.
        slots = [(count - 1 - j) % m for j in range(min(count, m))]
        vec, alphas = grad, []
        for i in slots:
            alpha = self.rho[i] * torch.dot(self.s[i], vec)
            vec = vec + (-alpha) * self.y[i]
            alphas.append(alpha)
        vec = gamma * vec
        for i, alpha in zip(reversed(slots), reversed(alphas)):
            beta = self.rho[i] * torch.dot(self.y[i], vec)
            vec = vec + (alpha - beta) * self.s[i]
        self.count = count + 1
        self.params, self.updates = params, grad
        return vec * -1.0


def _cubicmin(a, fa, fpa, b, fb, c, fc, dt):
    """linesearch.py:_cubicmin: the critical point of the cubic through
    (a, fa) with slope fpa at a, (b, fb) and (c, fc); NaN where there is
    none."""
    C = fpa
    db, dc = b - a, c - a
    # x**2 and x**3 as lax.integer_pow multiplies them out
    denom = ((db * dc) * (db * dc)) * (db - dc)
    r0, r1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * r0 + -(db * db) * r1) / denom
    B = (-(dc * (dc * dc)) * r0 + db * (db * db) * r1) / denom
    radical = B * B - dt(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (dt(3.0) * A)


def _quadmin(a, fa, fpa, b, fb, dt):
    """linesearch.py:_quadmin: the critical point of the quadratic through
    (a, fa) with slope fpa at a, and (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (dt(2.0) * B)


class _ZoomLinesearch:
    """One line search of optax.scale_by_zoom_linesearch along `updates`
    from `params`: Algorithms 3.5 (interval search) and 3.6 (zoom) of
    Nocedal and Wright with Hager and Zhang's approximate decrease. Scalars
    are numpy scalars of dtype dt on the host; gradients stay on the
    device."""

    def __init__(self, vg, reads: HostReads, dt, params, updates, value, grad,
                 stepsize_guess, max_steps: int = MAX_LINESEARCH_STEPS):
        self.vg, self.reads, self.dt, self.max_steps = vg, reads, dt, max_steps
        self.params, self.updates = params, updates
        self.stepsize_guess = stepsize_guess
        self.count = 0
        zero, inf = dt(0.0), dt(np.inf)
        self.stepsize, self.value, self.grad = zero, value, grad
        # the slope along updates at 0 is read with the first step's values
        self._slope0 = torch.dot(updates, grad)
        self.slope = self.slope_init = None
        self.value_init = value
        self.decrease_error = self.curvature_error = self.error = inf
        self.interval_found = self.done = self.failed = False
        self.low = self.high = self.cubic_ref = zero
        self.value_low = self.value_high = self.value_cubic_ref = value
        self.slope_low = self.slope_high = None
        self.safe_stepsize, self.safe_value, self.safe_grad = zero, value, grad
        self.trace = []   # each step's branch: interval, cubic, quad, bisect; safe

    def _on_line(self, stepsize):
        """Value, gradient and slope at params + stepsize * updates."""
        value, grad, _ = self.vg(self.params + self.updates * float(stepsize))
        slope = torch.dot(grad, self.updates)
        if self.slope_init is None:
            s0, value, slope = self.reads.fetch(self._slope0, value, slope)
            self.slope = self.slope_init = self.slope_low = self.slope_high = self.dt(s0)
        else:
            value, slope = self.reads.fetch(value, slope)
        return self.dt(value), grad, self.dt(slope)

    def _decrease_error(self, stepsize, value, slope):
        dt = self.dt
        err = value - self.value_init - dt(SLOPE_RTOL) * stepsize * self.slope_init
        approx = slope - dt(2 * SLOPE_RTOL - 1.0) * self.slope_init
        delta = value - self.value_init - dt(APPROX_DEC_RTOL) * np.abs(self.value_init)
        err = np.minimum(np.maximum(approx, delta), err)
        err = np.maximum(err, dt(0.0))
        return dt(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope):
        dt = self.dt
        err = np.maximum(np.abs(slope) - dt(CURV_RTOL) * np.abs(self.slope_init), dt(0.0))
        return dt(np.inf) if np.isnan(err) else err

    def _errors(self, stepsize, value, slope):
        dec = self._decrease_error(stepsize, value, slope)
        curv = self._curvature_error(slope)
        return dec, curv, np.maximum(dec, curv)

    def _search_interval(self):
        dt = self.dt
        first = self.count == 0
        prev = (self.stepsize, self.value, self.slope)
        new_step = self.stepsize_guess if first else dt(INCREASE_FACTOR) * self.stepsize
        self.trace.append("interval")
        value, grad, slope = self._on_line(new_step)
        if first:
            prev = (prev[0], prev[1], self.slope_init)
        dec, curv, err = self._errors(new_step, value, slope)
        if dec <= TOL:
            self.safe_stepsize, self.safe_value, self.safe_grad = new_step, value, grad
        high_to_new = bool(dec > 0.0) or (bool(value >= prev[1]) and not first)
        low_to_new = bool(slope >= 0.0) and not high_to_new
        new = (new_step, value, slope)
        lo, hi = (new, prev) if low_to_new else (prev, new)
        self.low, self.value_low, self.slope_low = lo
        self.high, self.value_high, self.slope_high = hi
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.interval_found = high_to_new or low_to_new or bool(err <= TOL)
        self.done = bool(err <= TOL)
        self.failed = self.count + 1 >= self.max_steps and not self.done
        self._set_step(new_step, value, grad, slope, dec, curv, err)

    def _zoom_into_interval(self):
        dt = self.dt
        low, high = self.low, self.high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = dt(0.2) * delta, dt(0.1) * delta
        too_small = bool(delta <= dt(STEPSIZE_PRECISION))
        cubic = _cubicmin(low, self.value_low, self.slope_low, high, self.value_high,
                          self.cubic_ref, self.value_cubic_ref, dt)
        quad = _quadmin(low, self.value_low, self.slope_low, high, self.value_high, dt)
        if left + cubic_chk < cubic < right - cubic_chk:
            middle, kind = cubic, "cubic"
        elif left + quad_chk < quad < right - quad_chk:
            middle, kind = quad, "quad"
        else:
            middle, kind = (low + high) / dt(2.0), "bisect"
        self.trace.append(kind)
        value, grad, slope = self._on_line(middle)
        dec, curv, err = self._errors(middle, value, slope)
        if dec <= TOL and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = middle, value, grad
        self.done = bool(err <= TOL)
        high_to_middle = bool(dec > 0.0) or bool(value >= self.value_low)
        high_to_low = bool(slope * (high - low) >= 0.0) and not high_to_middle
        old_low = (low, self.value_low, self.slope_low)
        old_high = (high, self.value_high, self.slope_high)
        mid = (middle, value, slope)
        new_high = old_low if high_to_low else (mid if high_to_middle else old_high)
        new_low = old_low if high_to_middle else mid
        self.cubic_ref, self.value_cubic_ref = (
            old_high[:2] if high_to_middle or high_to_low else old_low[:2])
        self.low, self.value_low, self.slope_low = new_low
        self.high, self.value_high, self.slope_high = new_high
        failed = self.count + 1 >= self.max_steps or (too_small and self.safe_stepsize > 0.0)
        self.failed = bool(failed) and not self.done
        self._set_step(middle, value, grad, slope, dec, curv, err)

    def _set_step(self, stepsize, value, grad, slope, dec, curv, err):
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = stepsize, value, grad, slope
        self.decrease_error, self.curvature_error, self.error = dec, curv, err

    def _try_safe_step(self):
        if self.safe_stepsize > 0.0 or np.isinf(self.decrease_error):
            self.trace.append("safe")
            self.stepsize, self.value, self.grad = (self.safe_stepsize, self.safe_value,
                                                    self.safe_grad)

    def run(self):
        """Steps until the conditions hold or the search fails (then the
        safe step); -> (stepsize, value, grad) at the accepted step."""
        with np.errstate(all="ignore"):
            while not (self.done or self.failed):
                if self.interval_found:
                    self._zoom_into_interval()
                else:
                    self._search_interval()
                if self.failed:
                    self._try_safe_step()
        return self.stepsize, self.value, self.grad


def lbfgs_drive(objective: Callable, x0: torch.Tensor, *, maxfun: int, thresh: float,
                min_iou_diff: float, info: Optional[dict] = None):
    """device_lbfgs_drive (cutie_tpu/ritm/brs.py:100-178): L-BFGS from x0
    with the reference driver's exits, on x0's device.

    objective(x) -> (loss, (track, mask, f_max_pos, f_max_neg)), differentiable
    in x by autograd; track is the tensor kept for the best loss, mask the
    boolean prediction whose change drives the IoU exit. The loop runs while
    the clicks are not satisfied (f_max_pos < 1 - thresh and f_max_neg <
    thresh), the mask changed by more than min_iou_diff in IoU (that exit
    only when min_iou_diff > 0), and fewer than maxfun evaluations were
    spent; an iteration spends its line search's steps (at least one) and
    ends with one more objective(x) for the exits and the best loss (strict
    <). -> (x, best_track, n_evals). info, if given, receives the exit
    ('clicks', 'iou' or 'maxfun'), the iterations, each line search's steps
    and branches, and the host reads."""
    dt = np.float64 if x0.dtype == torch.float64 else np.float32
    reads = HostReads()

    def vg(x):
        return value_and_grad(objective, x)

    def clicks_ok(fmp, fmn):
        return bool(dt(fmp) < dt(1 - thresh)) and bool(dt(fmn) < dt(thresh))

    x = x0.detach()
    value, grad, (best_track, last_mask, fmp, fmn) = vg(x)
    value, fmp, fmn = reads.fetch(value, fmp, fmn)
    value = best_loss = dt(value)
    exit_reason = "clicks" if clicks_ok(fmp, fmn) else None
    lbfgs, stepsize, evals, ls_steps, ls_trace = _LBFGS(x), dt(1.0), 0, [], []
    while exit_reason is None and evals < maxfun:
        if not np.isfinite(value):   # optax.value_and_grad_from_state
            value, grad, _ = vg(x)
            value = dt(reads.fetch(value)[0])
        direction = lbfgs.direction(grad, x)
        ls = _ZoomLinesearch(vg, reads, dt, x, direction, value, grad, stepsize)
        stepsize, value, grad = ls.run()
        x = x + direction * float(stepsize)
        with torch.no_grad():
            loss, (track, mask, fmp, fmn) = objective(x)
            inter, union = (mask & last_mask).sum(), (mask | last_mask).sum()
        loss, fmp, fmn, inter, union = reads.fetch(loss, fmp, fmn, inter, union)
        if dt(loss) < best_loss:
            best_loss, best_track = dt(loss), track.detach()
        iou_ok = union > 0 and dt(inter) / dt(max(union, 1)) > dt(1 - min_iou_diff)
        if clicks_ok(fmp, fmn):
            exit_reason = "clicks"
        elif min_iou_diff > 0 and iou_ok:
            exit_reason = "iou"
        last_mask = mask
        ls_steps.append(ls.count)
        ls_trace.append(ls.trace)
        evals += max(ls.count, 1)
    if info is not None:
        info.update(exit=exit_reason or "maxfun", iterations=len(ls_steps),
                    linesearch_steps=ls_steps, linesearch_trace=ls_trace,
                    host_reads=reads.count)
    return x, best_track, evals
