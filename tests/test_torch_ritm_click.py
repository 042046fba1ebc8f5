"""The port's RITM clicking (cutie_tpu_torch.ritm.{inference,brs,utils}) on
the CPU against cutie_tpu's: the automatic next click (scipy's EDT where
cutie_tpu calls cv2.distanceTransform), the transforms, the NoBRS
InteractiveController with undo and finish, one f-BRS objective and
gradient, the f-BRS-B endpoint of the port's scipy path (host_lbfgs=True)
against cutie_tpu's, the port's default driver (ritm/lbfgs.py, the device
drive) against both host paths, its undo and ClickController's default,
and the other BRS modes running to a finite result with either driver.

One cutie_tpu model serves the file (its compiled functions are cached by
model). Only the slow test compiles cutie_tpu's device_lbfgs_drive over
the RITM model (tests/test_torch_lbfgs.py holds the drive to it on small
objectives).

Tolerances: distance transforms to one ulp of cv2's, and clicks exactly
but where cv2's rounding breaks an exact tie (test_edt_click_matches_cv2);
transforms to 1e-6; the NoBRS probabilities to 1e-5 (measured ~1e-7: both
run the same fp32 operations in another order); the f-BRS loss to rtol
1e-5, its gradient to 1e-4 of its largest entry, the logits to 1e-5; the
f-BRS-B endpoint by the IoU of the two masks (measured 1.0), required
>= 0.99, and the scale/bias vectors to 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.ritm import brs, inference  # noqa: E402
from cutie_tpu_torch.ritm.model import HRNetISModel  # noqa: E402
from cutie_tpu_torch.ritm.utils import ClickController  # noqa: E402
from cutie_tpu_torch.ritm.weight_import import state_dict_tensors  # noqa: E402

HRNET = dict(width=18, ocr_width=64, small=False, with_prev_mask=True,
             use_disks=True, norm_radius=5, use_rgb_conv=False, use_leaky_relu=True)
ZOOM = {"skip_clicks": 1, "target_size": 64, "expansion_ratio": 1.4}
FBRS = {"brs_mode": "f-BRS-B", "net_clicks_limit": 8, "with_flip": True,
        "brs_opt_func_params": {"min_iou_diff": 1e-3}, "lbfgs_params": {"maxfun": 8}}


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """cutie_tpu's computations synchronous, as in tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.fixture(scope="module")
def models():
    """(the port's model, cutie_tpu's model, its variables) on the RITM
    golden weights, shared by the file."""
    from cutie_tpu.ritm.model import HRNetISModel as FlaxModel
    from cutie_tpu.ritm.weight_import import convert_ritm_state_dict

    sd = dict(np.load(require_golden("ritm_state_dict.npz")))
    port = HRNetISModel(**HRNET).eval()
    port.load_state_dict(state_dict_tensors(sd), strict=True)
    flax_model = FlaxModel(**HRNET)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 4)), jnp.full((1, 2, 3), -1.0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return port, flax_model, convert_ritm_state_dict(sd, zeros, strict=True)


def _controllers(models, params, host_lbfgs=False):
    from cutie_tpu.ritm.inference import InteractiveController as FlaxController

    port, flax_model, variables = models
    if host_lbfgs:
        params = {**params, "predictor_params": {"host_lbfgs": True}}
    return (inference.InteractiveController(port, params),
            FlaxController(flax_model, variables, params))


def _blob(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), bool)
    for _ in range(3):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(3, 12)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
    return m


def _cv2_and_exact_maps(clicker, pred):
    """(cv2's, the exact) distance maps that _get_next_click compares, as
    cutie_tpu's Clicker computes them with cv2.distanceTransform."""
    import cv2

    out = []
    for mask in (clicker.gt_mask & ~pred & clicker.not_ignore_mask,
                 ~clicker.gt_mask & pred & clicker.not_ignore_mask):
        padded = np.pad(mask, 1).astype(np.uint8)
        out.append((cv2.distanceTransform(padded, cv2.DIST_L2, 0)[1:-1, 1:-1],
                    inference.distance_transform(padded)[1:-1, 1:-1]))
    return out


def test_edt_click_matches_cv2():
    """Clicker._get_next_click with scipy's exact EDT against cutie_tpu's
    with cv2.distanceTransform(DIST_L2, 0), three clicks on each of 200
    seeded mask pairs (ignored pixels, clicked pixels). cv2 5.0's distances
    are its float sqrt, one ulp off the exact value at some pixels, and
    which pixels depends on its thread count (measured: 498 and 14,330 of
    8.2 M pixels at 8 and 1 threads). So: the distances agree to one ulp,
    and every click agrees (sign, and the first maximum in np.where's
    order) unless cv2 broke an exact tie with such an ulp: then the two
    clicks are exactly as far from the region's border, and cv2's value at
    its own click is off. Such clicks stay under 1% (measured 2-3 in
    1,200)."""
    from cutie_tpu.ritm.inference import Clicker as FlaxClicker

    rng = np.random.default_rng(0)
    clicks = ulp_broken = 0
    for case in range(200):
        h, w = rng.integers(20, 120, size=2)
        gt, pred = _blob(rng, h, w), _blob(rng, h, w)
        if case == 0:
            pred = gt.copy()
            pred[5:9, 5:9] = ~pred[5:9, 5:9]
        gt_mask = gt.astype(np.int32)
        gt_mask[rng.random((h, w)) < 0.02] = -1   # ignored pixels
        ours, theirs = inference.Clicker(gt_mask), FlaxClicker(gt_mask)
        for _ in range(3):
            maps = _cv2_and_exact_maps(ours, pred)
            for cv2_map, exact in maps:
                np.testing.assert_allclose(exact, cv2_map, rtol=1.2e-7, atol=0)
            a, b = ours._get_next_click(pred), theirs._get_next_click(pred)
            clicks += 1
            if (a.is_positive, a.coords) != (b.is_positive, b.coords):
                ulp_broken += 1
                cv2_map, exact = maps[0 if b.is_positive else 1]
                exact = exact * ours.not_clicked_map
                assert exact[b.coords] == exact[a.coords] == exact.max(), case
                assert cv2_map[b.coords] != exact[b.coords], case
            ours.add_click(a)
            theirs.add_click(a)
    assert ulp_broken <= 0.01 * clicks, (ulp_broken, clicks)


def test_transforms_match_cutie_tpu():
    """LimitLongestSide, ZoomIn (ROI from the previous probabilities) and
    the flip, forward and inverse, against cutie_tpu's host cascade."""
    from cutie_tpu.ritm import inference as flax_inference

    rng = np.random.default_rng(1)
    image = rng.random((1, 4, 50, 130)).astype(np.float32)
    clicks = [inference.Click(True, (20, 70)), inference.Click(False, (30.5, 12.25))]
    theirs_clicks = [flax_inference.Click(c.is_positive, c.coords) for c in clicks]
    prev = np.zeros((1, 1, 50, 130), np.float32)
    prev[0, 0, 10:30, 50:90] = 0.9
    ours_t = [inference.ZoomIn(target_size=40), inference.LimitLongestSide(64),
              inference.AddHorizontalFlip()]
    theirs_t = [flax_inference.ZoomIn(target_size=40), flax_inference.LimitLongestSide(64),
                flax_inference.AddHorizontalFlip()]
    ours_t[0]._prev_probs = torch.from_numpy(prev)
    theirs_t[0]._prev_probs = prev
    x, cl = torch.from_numpy(image), [clicks]
    y, tcl = image, [theirs_clicks]
    for o, t in zip(ours_t, theirs_t):
        x, cl = o.transform(x, cl)
        y, tcl = t.transform(y, tcl)
        np.testing.assert_allclose(x.numpy(), y, atol=1e-6)
        assert [[c.coords for c in c1] for c1 in cl] == [[c.coords for c in c1] for c1 in tcl]
    assert ours_t[0]._object_roi == theirs_t[0]._object_roi is not None
    logits = rng.standard_normal(x.shape[:1] + (1,) + x.shape[2:]).astype(np.float32)
    p, q = torch.from_numpy(logits), logits
    for o, t in zip(reversed(ours_t), reversed(theirs_t)):
        p, q = o.inv_transform(p), t.inv_transform(q)
        np.testing.assert_allclose(p.numpy(), q, atol=1e-6)
    assert p.shape == (1, 1, 50, 130)


def test_click_maps_match_host_maps():
    """click_maps_from_points over map_points equals cutie_tpu's host
    _clicks_maps, fractional coordinates (halves round to even) and clicks
    at the border included."""
    from cutie_tpu.ritm.brs import HRNetFeatureBRSPredictor

    clicks_lists = [[inference.Click(True, (0, 0)), inference.Click(False, (10.5, 11.5)),
                     inference.Click(True, (19, 30.49)), inference.Click(False, (4.6, 29))],
                    [inference.Click(False, (7, 7))]]
    pos, neg = brs.click_maps_from_points(brs.map_points(clicks_lists, "cpu"), 20, 31)
    want = HRNetFeatureBRSPredictor._clicks_maps(None, clicks_lists, 20, 31)
    np.testing.assert_array_equal(pos.numpy(), want[0])
    np.testing.assert_array_equal(neg.numpy(), want[1])


def test_nobrs_controller_flow_matches_cutie_tpu(models):
    """tests/test_ritm.py::test_interactive_controller_flow's clicks at 64x96
    through both controllers: the probabilities of every click, the undo,
    a click after it, and the result mask of finish_object."""
    ours, theirs = _controllers(models, {"net_clicks_limit": 8, "with_flip": True,
                                         "zoom_in_params": ZOOM})
    image = np.random.default_rng(0).uniform(0.2, 0.8, size=(3, 64, 96)).astype(np.float32)
    ours.set_image(image)
    theirs.set_image(image)
    for x, y, positive in [(40, 30, True), (60, 20, False)]:
        a, b = ours.add_click(x, y, positive), theirs.add_click(x, y, positive)
        assert a.shape == (1, 1, 64, 96) and 0.0 <= a.min() and a.max() <= 1.0
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert ours.predictor.zoom_in._object_roi == theirs.predictor.zoom_in._object_roi
    assert ours.predictor.zoom_in._object_roi is not None
    ours.undo_click()
    theirs.undo_click()
    assert len(ours.clicker) == len(theirs.clicker) == 1
    np.testing.assert_allclose(ours.current_object_prob, theirs.current_object_prob,
                               atol=1e-5)
    a, b = ours.add_click(62, 22, False), theirs.add_click(62, 22, False)
    np.testing.assert_allclose(a, b, atol=1e-5)
    ours.finish_object()
    theirs.finish_object()
    assert ours.object_count == theirs.object_count == 1
    np.testing.assert_array_equal(ours.result_mask, theirs.result_mask)
    assert ours.result_mask.max() == 1


def _fbrs_image():
    return np.random.default_rng(7).uniform(0.2, 0.8, size=(3, 64, 96)).astype(np.float32)


def _mask_iou(a, b):
    a, b = a[0, 0] > 0.5, b[0, 0] > 0.5
    return np.logical_and(a, b).sum() / np.logical_or(a, b).sum()


@pytest.fixture(scope="module")
def fbrs_runs(models):
    """tests/test_ritm.py::test_device_brs_matches_host_endpoint's clicks
    through the port and cutie_tpu's host L-BFGS path (f-BRS-B, maxfun 8):
    a click, then a positive click where the first prediction is least
    foreground, so that the optimiser must engage."""
    ours, theirs = _controllers(models, FBRS, host_lbfgs=True)
    image = _fbrs_image()
    ours.set_image(image)
    theirs.set_image(image)
    p1 = ours.add_click(30, 20, True), theirs.add_click(30, 20, True)
    yy, xx = np.unravel_index(np.argmin(p1[1][0, 0]), p1[1][0, 0].shape)
    p2 = ours.add_click(int(xx), int(yy), True), theirs.add_click(int(xx), int(yy), True)
    return ours, theirs, p1, p2, (yy, xx)


def test_fbrs_endpoint_matches_host_lbfgs(fbrs_runs):
    ours, theirs, p1, p2, (yy, xx) = fbrs_runs
    np.testing.assert_allclose(p1[0], p1[1], atol=1e-5)   # click 1: no optimisation
    assert p1[1][0, 0, yy, xx] < 0.49
    assert ours.predictor.opt_functor.n_evals > 1
    assert np.linalg.norm(ours.predictor.opt_data) > 0
    assert p2[0][0, 0, yy, xx] > p1[0][0, 0, yy, xx]
    mine, want = p2[0][0, 0] > 0.5, p2[1][0, 0] > 0.5
    iou = np.logical_and(mine, want).sum() / np.logical_or(mine, want).sum()
    assert iou >= 0.99, iou
    np.testing.assert_allclose(ours.predictor.opt_data, np.asarray(theirs.predictor.opt_data),
                               atol=1e-3)


@pytest.fixture(scope="module")
def fbrs_device_run(models, fbrs_runs):
    """fbrs_runs' clicks through the port's default driver, the device
    drive (ritm/lbfgs.py)."""
    *_, (yy, xx) = fbrs_runs
    ctl = inference.InteractiveController(models[0], FBRS)
    ctl.set_image(_fbrs_image())
    q1 = ctl.add_click(30, 20, True)
    q2 = ctl.add_click(int(xx), int(yy), True)
    return ctl, q1, q2


def test_device_drive_endpoint_matches_host_paths(fbrs_runs, fbrs_device_run):
    """The default f-BRS-B click (the device drive) against the port's and
    cutie_tpu's host L-BFGS paths on the same clicks: the first click (no
    optimisation) equal, the optimiser engaged on the second, the forced
    click's probability raised, and the masks within the bar that
    tests/test_ritm.py::test_device_brs_matches_host_endpoint sets between
    cutie_tpu's two drivers: IoU > 0.8 (measured 1.0 against both). The
    budget: fewer than maxfun evaluations before the last line search."""
    ours_host, _, p1, p2, (yy, xx) = fbrs_runs
    ctl, q1, q2 = fbrs_device_run
    np.testing.assert_array_equal(q1, p1[0])
    pred = ctl.predictor
    info = pred.opt_functor.drive_info
    assert not pred.host_lbfgs and ours_host.predictor.host_lbfgs
    assert isinstance(pred.opt_data, torch.Tensor) and float(pred.opt_data.norm()) > 0
    assert info["iterations"] >= 1 and pred.opt_functor.n_evals >= 1
    maxfun = FBRS["lbfgs_params"]["maxfun"]
    assert pred.opt_functor.n_evals - info["linesearch_steps"][-1] < maxfun
    assert q2[0, 0, yy, xx] > q1[0, 0, yy, xx]
    assert _mask_iou(q2, p2[0]) > 0.8, _mask_iou(q2, p2[0])
    assert _mask_iou(q2, p2[1]) > 0.8, _mask_iou(q2, p2[1])


def test_undo_restores_device_opt_data(models):
    """The device drive keeps opt_data a tensor on the model's device; undo
    restores the vector of the click before, a copy that the next drive
    does not touch, and a click after the undo starts from it."""
    ctl = inference.InteractiveController(models[0], {**FBRS, "lbfgs_params": {"maxfun": 4}})
    ctl.set_image(_fbrs_image())
    ctl.add_click(30, 20, True)
    ctl.add_click(70, 40, False)
    after2 = ctl.predictor.opt_data
    kept = after2.clone()
    p3 = ctl.add_click(10, 50, True)
    assert not torch.equal(ctl.predictor.opt_data, kept)
    ctl.undo_click()
    assert isinstance(ctl.predictor.opt_data, torch.Tensor)
    assert torch.equal(ctl.predictor.opt_data, kept) and torch.equal(after2, kept)
    assert ctl.predictor.opt_data is not after2
    np.testing.assert_array_equal(ctl.add_click(10, 50, True), p3)


@pytest.mark.slow
def test_device_drive_matches_cutie_tpu_device_drive(models, fbrs_device_run):
    """The port's device drive against cutie_tpu's device_lbfgs_drive (its
    default path) on fbrs_runs' clicks, through both InteractiveControllers.
    Compiling cutie_tpu's drive over the RITM model takes minutes, so the
    test is marked slow. Both run the same L-BFGS in fp32 on features that
    differ by float rounding: measured, the probabilities within 1.2e-7 and
    the scale/bias vectors within 3.6e-7 (required: 1e-5), masks equal."""
    from cutie_tpu.ritm.inference import InteractiveController as FlaxController

    _, flax_model, variables = models
    ctl, q1, q2 = fbrs_device_run
    theirs = FlaxController(flax_model, variables, FBRS)
    theirs.set_image(_fbrs_image())
    t1 = theirs.add_click(30, 20, True)
    yy, xx = np.unravel_index(np.argmin(t1[0, 0]), t1.shape[2:])
    t2 = theirs.add_click(int(xx), int(yy), True)
    np.testing.assert_allclose(q1, t1, atol=1e-5)
    assert _mask_iou(q2, t2) == 1.0, _mask_iou(q2, t2)
    np.testing.assert_allclose(q2, t2, atol=1e-5)
    np.testing.assert_allclose(ctl.predictor.opt_data.numpy(),
                               np.asarray(theirs.predictor.opt_data), atol=1e-5)


def test_fbrs_objective_and_gradient_match_cutie_tpu(fbrs_runs):
    """One evaluation of the f-BRS-B objective (loss plus regulariser, its
    gradient, the logits, the click maxima) at a fixed scale/bias vector,
    each side on its own cached features of the second click."""
    ours, theirs, *_ = fbrs_runs
    op, tp = ours.predictor, theirs.predictor
    clicks = ours.clicker.get_clicks()
    x_in = torch.cat([op.original_image, op.prev_prediction], 1)
    image_nd, clicks_lists = op._apply_transforms(x_in, [clicks])
    b, _, h, w = image_nd.shape
    hp, wp = inference.pad_hw(h, w)
    feats = np.asarray(tp.input_data)                      # NHWC
    np.testing.assert_allclose(op.input_data.numpy(), feats.transpose(0, 3, 1, 2),
                               atol=1e-4 * np.abs(feats).max())
    pos_h, neg_h = tp._clicks_maps(clicks_lists, h, w)
    pos = np.zeros((b, hp, wp), np.float32)
    neg = np.zeros((b, hp, wp), np.float32)
    pos[:, :h, :w], neg[:, :h, :w] = pos_h, neg_h
    x = np.random.default_rng(3).standard_normal(2 * op.num_channels).astype(np.float32) * 0.05
    want = tp._loss_grad(tp.variables, tp.input_data, jnp.asarray(pos), jnp.asarray(neg),
                         jnp.asarray(x), out_h=hp, out_w=wp, bs=1)
    got_pos, got_neg = brs.padded_click_maps(clicks_lists, h, w, hp, wp, "cpu")
    np.testing.assert_array_equal(got_pos.numpy(), pos)
    np.testing.assert_array_equal(got_neg.numpy(), neg)
    objective = op.objective(got_pos, got_neg, hp, wp, w, 1)
    loss, grad, logits, fmp, fmn = brs._value_and_grad(objective, x.astype(np.float64), "cpu")
    w_loss, w_grad, w_low, w_fmp, w_fmn = (np.asarray(v) for v in want)
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), w_grad, atol=1e-4 * np.abs(w_grad).max())
    w_logits = inference.bilinear_resize_align_corners(
        torch.from_numpy(w_low[:, None]), hp, wp)[:, 0].numpy()
    np.testing.assert_allclose(logits.numpy(), w_logits, atol=1e-5)
    np.testing.assert_allclose([float(fmp), float(fmn)], [float(w_fmp), float(w_fmn)],
                               atol=1e-5)


@pytest.mark.parametrize("mode,host_lbfgs", [
    pytest.param(mode, host, id=mode + ("" if host else "-device_drive"))
    for mode in ("f-BRS-C", "RGB-BRS", "DistMap-BRS") for host in (True, False)])
def test_other_brs_modes_run_finite(models, mode, host_lbfgs):
    """f-BRS-C and the input-BRS pair on the port with each driver (scipy
    on the host; the device drive, the default), where cutie_tpu's tests run
    them only through its on-device L-BFGS: the second click gives finite
    probabilities in [0, 1] that keep the negative click background, as
    tests/test_ritm.py::test_brs_mode_variants asks; a third, positive click
    where the second prediction is least foreground engages the optimiser
    and raises the probability there."""
    ctl = inference.InteractiveController(models[0], {
        "brs_mode": mode, "with_flip": True, "zoom_in_params": ZOOM,
        "predictor_params": {"host_lbfgs": host_lbfgs},
        "brs_opt_func_params": {"min_iou_diff": 1e-3}, "lbfgs_params": {"maxfun": 3}})
    image = np.random.default_rng(3).uniform(0.2, 0.8, size=(3, 64, 96)).astype(np.float32)
    ctl.set_image(image)
    ctl.add_click(40, 30, True)
    p2 = ctl.add_click(20, 10, False)
    assert p2.shape == (1, 1, 64, 96) and np.all(np.isfinite(p2))
    assert 0.0 <= p2.min() and p2.max() <= 1.0
    functor = ctl.predictor.opt_functor
    assert ctl.predictor.opt_data is not None
    # scipy evaluates at least once; the device drive, as cutie_tpu's, not
    # at all when the clicks already hold at its starting point
    assert functor.n_evals >= 1 if host_lbfgs else functor.drive_info is not None
    assert p2[0, 0, 10, 20] < 0.9
    yy, xx = np.unravel_index(np.argmin(p2[0, 0]), p2.shape[2:])
    p3 = ctl.add_click(int(xx), int(yy), True)
    assert np.all(np.isfinite(p3)) and 0.0 <= p3.min() and p3.max() <= 1.0
    assert functor.n_evals >= 1
    assert p3[0, 0, yy, xx] > p2[0, 0, yy, xx]


def test_click_controller_on_the_cpu():
    """ClickController(device='cpu'): the GUI's predictor parameters on a
    random HRNet-18/OCR-64, fp32 on the CPU, clicks, undo and a caller's
    previous mask."""
    ctl = ClickController(None, device="cpu")
    assert not ctl.model.amp and ctl.controller.predictor.opt_functor.optimizer_params[
        "maxfun"] == 20
    assert not ctl.controller.predictor.host_lbfgs
    image = np.random.default_rng(5).uniform(0, 1, size=(3, 72, 100)).astype(np.float32)
    p1 = ctl.interact(image, 50, 36, True)
    p2 = ctl.interact(image, 20, 10, False)
    p3 = ctl.interact(image, 70, 40, True, prev_mask=(p2[0, 0] > 0.5).astype(np.float32))
    for p in (p1, p2, p3):
        assert p.shape == (1, 1, 72, 100) and np.all(np.isfinite(p))
        assert 0.0 <= p.min() and p.max() <= 1.0
    assert isinstance(ctl.controller.predictor.opt_data, torch.Tensor)
    assert ctl.controller.predictor.opt_functor.drive_info is not None
    undone = ctl.undo()
    np.testing.assert_array_equal(undone, (p2 > 0.5).astype(np.float32))
    assert len(ctl.controller.clicker) == 2


def test_click_controller_driver_choice():
    """ClickController runs the device drive by default, as cutie_tpu's
    does, and scipy's L-BFGS with host_lbfgs=True; NoBRS has no driver."""
    assert not ClickController(None, device="cpu").controller.predictor.host_lbfgs
    assert ClickController(None, device="cpu",
                           host_lbfgs=True).controller.predictor.host_lbfgs
    assert not hasattr(ClickController(None, brs_mode="NoBRS", device="cpu")
                       .controller.predictor, "host_lbfgs")
