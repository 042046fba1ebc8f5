"""The port's L-BFGS drive (cutie_tpu_torch/ritm/lbfgs.py:lbfgs_drive)
against cutie_tpu's device_lbfgs_drive (optax 0.2.6's L-BFGS with its zoom
line search under a while_loop) on the CPU, on small objectives defined in
both frameworks from numpy-seeded data.

Each case runs in float32, the dtype of the f-BRS clicks, and in float64
(jax.enable_x64 scoped to the test, torch in float64), where the two
trajectories agree to rounding and so the port's record of its line
searches is the reference's. The cases and the branches they take:
  quadratic       16-d convex quadratic, condition 100: interval steps and
                  quadratic zooms; the maxfun exit;
  quadratic_maxfun3  the same with maxfun 3: the budget runs out inside the
                  second line search, which still finishes (4 evaluations);
  rosenbrock      16-d Rosenbrock: interval steps and a quadratic zoom;
  vee             a V-shaped valley (sqrt(1 + k^2 |x - c|^2) / k, k = 1e4):
                  quadratic then cubic zooms that reach the 8-step cap and
                  take the safe step (sufficient decrease without the
                  curvature condition), and an interval search that doubles
                  the step until the cap;
  fbrs_zoom       a mini f-BRS objective (sigmoid of scaled and biased seeded
                  features, brs_mask_loss on seeded click maps, the
                  scale/bias regulariser): searches of up to 3 steps with
                  quadratic, cubic and bisection zooms;
  fbrs_clicks     the same objective with clicks it can satisfy: one
                  interval search, then the clicks exit;
  fbrs_iou        clicks it cannot satisfy (positive and negative clicks on
                  pixels of close logits), min_iou_diff 1e-2: the IoU exit;
  clicks_at_start clicks that already hold at x0: no iteration, 0
                  evaluations.
Required: equal evaluation counts and the same exit (cutie_tpu's exit read
from its end point: the clicks hold there, or else fewer than maxfun
evaluations means the IoU exit), x and the best track within 1e-4 of their
largest magnitude (at least 1) in float32 (measured: up to 1.1e-6 relative,
fbrs_zoom's track) and within 1e-10 in float64 (measured up to 1.6e-14, fbrs_iou).

device_lbfgs_drive counts evaluations in int32 while optax's line search
counts in int64 under x64, which its while_loop refuses; the float64 runs
therefore hand that module a jnp whose int32 asarray is int64 (the counter's
values are the same).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu.ritm import brs as jax_brs  # noqa: E402
from cutie_tpu_torch.ritm import brs  # noqa: E402
from cutie_tpu_torch.ritm.lbfgs import lbfgs_drive  # noqa: E402

THRESH = 0.49
N = 16
H, W, C = 48, 64, 8


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """cutie_tpu's computations synchronous, as in tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


class _Int64Counts:
    """jax.numpy, but asarray(., int32) is int64 (the eval counter)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, dtype=None, **kw):
        return jnp.asarray(a, jnp.int64 if dtype == jnp.int32 else dtype, **kw)


def _aux_none(x, mask):
    """The aux of an objective without clicks: clicks never satisfied."""
    one = (jnp.ones((), x.dtype) if isinstance(x, jax.Array)
           else torch.ones((), dtype=x.dtype))
    return x, mask, one, one


def _quadratic():
    rng = np.random.default_rng(0)
    u, _ = np.linalg.qr(rng.standard_normal((N, N)))
    hess = ((u * np.geomspace(1, 100, N)) @ u.T).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)

    def fj(x):
        v = 0.5 * x @ (jnp.asarray(hess, x.dtype) @ x) - jnp.asarray(b, x.dtype) @ x
        return v, _aux_none(x * 2, x > 0)

    def ft(x):
        ht, bt = torch.from_numpy(hess).to(x.dtype), torch.from_numpy(b).to(x.dtype)
        return 0.5 * x @ (ht @ x) - bt @ x, _aux_none(x * 2, x > 0)

    return fj, ft, np.zeros(N)


def _rosenbrock():
    x0 = -1.0 + 0.1 * np.random.default_rng(1).standard_normal(N)

    def fj(x):
        v = jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
        return v, _aux_none(x, x > 1)

    def ft(x):
        v = (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()
        return v, _aux_none(x, x > 1)

    return fj, ft, x0


def _vee(k=1e4, alpha=0.3):
    u = np.random.default_rng(2).standard_normal(N)
    c = alpha * u / np.linalg.norm(u)

    def fj(x):
        r2 = jnp.sum((x - jnp.asarray(c, x.dtype)) ** 2)
        return jnp.sqrt(1 + k * k * r2) / k, _aux_none(x, x > 0)

    def ft(x):
        r2 = ((x - torch.from_numpy(c).to(x.dtype)) ** 2).sum()
        return torch.sqrt(1 + k * k * r2) / k, _aux_none(x, x > 0)

    return fj, ft, np.zeros(N)


def _fbrs(pick, h=H, w=W):
    """The mini f-BRS objective over seeded features [1, h, w, C]: low =
    sum_c (f * (1 + scale) + bias) * v_c, its sigmoid against click maps at
    pick(order of the unmodified logits) -> (positive, negative) pixel
    indices; track = low, mask = low > 0."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((1, h, w, C)).astype(np.float32)
    v = rng.standard_normal(C).astype(np.float32)
    order = np.argsort((feats @ v).ravel())
    maps = np.zeros((2, 1, h * w), np.float32)
    for i, idx in enumerate(pick(order)):
        maps[i, 0, idx] = 1.0
    pos, neg = maps.reshape(2, 1, h, w)
    jf, tf = jax_brs.ScaleBiasOptimizer(prob_thresh=THRESH), brs.ScaleBiasOptimizer(
        prob_thresh=THRESH)
    feats_t = torch.from_numpy(feats).permute(0, 3, 1, 2)

    def fj(x):
        scale, bias, reg = jf.unpack_scale_bias(x, 1)
        low = jnp.sum((jnp.asarray(feats, x.dtype) * scale + bias) * jnp.asarray(v, x.dtype),
                      -1)
        loss, fmp, fmn = jax_brs.brs_mask_loss(jax.nn.sigmoid(low), jnp.asarray(pos, x.dtype),
                                               jnp.asarray(neg, x.dtype))
        return loss + reg, (low, low > 0, fmp, fmn)

    def ft(x):
        scale, bias, reg = tf.unpack_scale_bias(x, 1)
        low = ((feats_t.to(x.dtype) * scale + bias)
               * torch.from_numpy(v).to(x.dtype)[:, None, None]).sum(1)
        loss, fmp, fmn = brs.brs_mask_loss(torch.sigmoid(low), torch.from_numpy(pos).to(x.dtype),
                                           torch.from_numpy(neg).to(x.dtype))
        return loss + reg, (low, low > 0, fmp, fmn)

    return fj, ft, np.zeros(2 * C)


def _middle(order, n=80):
    m = len(order) // 2
    return order[m - n // 2:m + n // 2]


# name -> (objective builder, maxfun, min_iou_diff, exit, branches taken)
CASES = {
    "quadratic": (_quadratic, 20, 0.0, "maxfun", {"interval", "quad"}),
    "quadratic_maxfun3": (_quadratic, 3, 0.0, "maxfun", {"interval", "quad"}),
    "rosenbrock": (_rosenbrock, 20, 0.0, "maxfun", {"interval", "quad"}),
    "vee": (_vee, 20, 0.0, "maxfun", {"interval", "quad", "cubic", "safe"}),
    "fbrs_zoom": (functools.partial(_fbrs, lambda o: (o[10:30], np.r_[o[-30:-10], o[5:8]]),
                                    h=24, w=32),
                  20, 1e-3, "maxfun", {"interval", "quad", "cubic", "bisect"}),
    "fbrs_clicks": (functools.partial(_fbrs, lambda o: (o[300:303], o[-300:-297])),
                    20, 1e-3, "clicks", {"interval"}),
    "fbrs_iou": (functools.partial(_fbrs, lambda o: (_middle(o)[::2], _middle(o)[1::2])),
                 20, 1e-2, "iou", {"interval", "quad"}),
    "clicks_at_start": (functools.partial(_fbrs, lambda o: (o[-3:], o[:3])),
                        20, 1e-3, "clicks", set()),
}


def _jax_drive(fj, x0, maxfun, min_iou_diff):
    """device_lbfgs_drive under jit -> (x, best track, evaluations, exit)."""
    run = jax.jit(functools.partial(jax_brs.device_lbfgs_drive, fj, maxfun=maxfun,
                                    thresh=THRESH, min_iou_diff=min_iou_diff))
    x, track, n = run(jnp.asarray(x0))
    _, (_, _, fmp, fmn) = fj(x)
    if fmp < 1 - THRESH and fmn < THRESH:
        exit_reason = "clicks"
    else:
        exit_reason = "iou" if int(n) < maxfun else "maxfun"
    return np.asarray(x), np.asarray(track), int(n), exit_reason


def _gradient_norm(ft, x0) -> float:
    x = torch.from_numpy(x0).requires_grad_()
    grad, = torch.autograd.grad(ft(x)[0], x)
    return float(grad.double().norm())


def _scaled(fj, c: float):
    """The objective fj times c, its aux as it is."""
    def fn(x):
        value, aux = fj(x)
        return value * jnp.asarray(c, x.dtype), aux
    return fn


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(CASES))
def test_drive_matches_device_lbfgs_drive(case, dtype, monkeypatch):
    build, maxfun, min_iou_diff, want_exit, branches = CASES[case]
    fj, ft, x0 = build()
    x0 = x0.astype(dtype)
    x64 = dtype == "float64"
    if x64:
        monkeypatch.setattr(jax_brs, "jnp", _Int64Counts())
    # The port's first step is one long, as scipy's L-BFGS-B (which upstream
    # f-BRS runs) takes it; optax's is min(1, 1 / |g0|) |g0| long, the
    # same where |g0| >= 1. L-BFGS with the zoom line search does not see
    # the objective's scale (its tests are relative), so where |g0| < 1 the
    # reference runs on f / |g0|, whose first step is one long too.
    g0 = _gradient_norm(ft, x0)
    if g0 < 1:
        fj = _scaled(fj, 1.0 / g0)
    with jax.enable_x64(x64):
        want_x, want_track, want_n, jax_exit = _jax_drive(fj, x0, maxfun, min_iou_diff)
    info = {}
    x, track, n = lbfgs_drive(ft, torch.from_numpy(x0), maxfun=maxfun, thresh=THRESH,
                              min_iou_diff=min_iou_diff, info=info)
    assert (n, info["exit"]) == (want_n, jax_exit) == (want_n, want_exit), info
    assert x.dtype == torch.float64 if x64 else torch.float32
    tol = 1e-10 if x64 else 1e-4
    for got, want in ((x.numpy(), want_x), (track.numpy(), want_track)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(1.0, float(np.abs(want).max())))
    taken = {b for trace in info["linesearch_trace"] for b in trace}
    assert taken == branches, (taken, info)
    if case == "quadratic_maxfun3":
        assert n > maxfun and n - info["linesearch_steps"][-1] < maxfun
    if case == "vee":
        assert max(info["linesearch_steps"]) == 8


def test_drive_reads_scalars_only():
    """Every read of the device by the drive is one fetch of scalars: one
    for the start, one a line-search step, one an iteration's end."""
    fj, ft, x0 = _quadratic()
    info = {}
    lbfgs_drive(ft, torch.from_numpy(x0.astype(np.float32)), maxfun=20, thresh=THRESH,
                min_iou_diff=0.0, info=info)
    assert info["host_reads"] == 1 + sum(info["linesearch_steps"]) + info["iterations"]
