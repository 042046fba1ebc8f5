"""The port's RITM click model against the benchmark's plain reference
(vosbench/reference/ritm: RITM's HRNet-18 + OCR and f-BRS-B in plain
float32 torch), at HRNet-18's full width with OCR 64, on seeded random
weights (vosbench/events/click.py:click_weights) and inputs of about
96x96, on the CPU.

Tolerances: both sides run float32 on the CPU with the same weights, so
they part only by rounding (FrozenBatchNorm folds the statistics where
BatchNorm2d subtracts them; the port's objective resizes by matmuls):
measured, the aggregated features agree to 5e-7 of their largest and the
logits to 1.6e-6 of theirs, each held to 1e-6 and 4e-6; TF32 (10-bit
mantissa) moves either by ~1e-3 relative, two orders above every
tolerance here."""
import numpy as np
import pytest
import torch

from cutie_tpu_torch.ritm.brs import (HRNetFeatureBRSPredictor, ScaleBiasOptimizer,
                                      click_maps_from_points, map_points)
from cutie_tpu_torch.ritm.inference import Click as PortClick, pad_hw, pad_to
from cutie_tpu_torch.ritm.utils import load_is_model
from vosbench.events import kind
from vosbench.reference.ritm import Click, HRNetISModel, Interaction, Params
from vosbench.weights import load_weights

MODEL = dict(width=18, ocr_width=64, small=False, with_prev_mask=True, use_disks=True,
             norm_radius=5, use_rgb_conv=False, use_leaky_relu=True)
SEED = 11
# the click pass's weights: its first click leaves pixels above 0.5, so the
# second is zoomed in
CLICK_SEED = 21


@pytest.fixture(scope="module")
def nets():
    torch.set_num_threads(2)
    weights = kind("click").click_weights
    port = load_is_model(None, "cpu", amp=False, **MODEL)
    load_weights(port, weights(port, SEED, "cpu"))
    ref = HRNetISModel(**MODEL).eval()
    load_weights(ref, weights(ref, SEED, "cpu"))
    return port, ref


def _inputs(h=96, w=80, b=2):
    g = torch.Generator().manual_seed(3)
    image = torch.rand(b, 4, h, w, generator=g)
    # the previous mask: a soft blob, as a prediction is
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    image[:, 3] = torch.sigmoid(8 - ((yy - 40) ** 2 + (xx - 30) ** 2) / 40.0)
    points = torch.tensor([[[30., 20, 0], [50, 41, 2], [70, 60, 1], [-1, -1, -1]],
                           [[30., 59, 0], [-1, -1, -1], [70, 19, 1], [-1, -1, -1]]])[:b]
    return image, points


def test_nobrs_forward_with_prev_mask_and_disks(nets):
    """The click model's forward (NoBRS), the padded input as the port's
    predictor gives it: features to 1e-6 of their largest, logits to 4e-6
    of theirs; the previous mask and the clicks each move the logits by
    ten times that or more."""
    port, ref = nets
    image, points = _inputs()
    hp, wp = pad_hw(*image.shape[-2:])
    padded = pad_to(image, hp, wp)
    with torch.no_grad():
        feats_port = port.get_head_input(padded, points, "A")
        feats_ref = ref.features(padded, points)
        logits_port = port(padded, points)["instances"]
        logits_ref = ref(padded, points)
    scale = float(feats_ref.abs().max())
    assert float((feats_port - feats_ref).abs().max()) < 1e-6 * scale
    tol = 4e-6 * float(logits_ref.abs().max())
    assert float((logits_port - logits_ref).abs().max()) < tol
    with torch.no_grad():
        no_prev = ref(torch.cat([padded[:, :3], 0 * padded[:, 3:]], 1), points)
        no_clicks = ref(padded, torch.full_like(points, -1.0))
    assert float((no_prev - logits_ref).abs().max()) > 10 * tol
    assert float((no_clicks - logits_ref).abs().max()) > 10 * tol


def test_fbrs_b_objective_and_gradient(nets):
    """f-BRS-B's objective (BRSMaskLoss over the flip pair plus the
    regulariser) and its gradient in the scale and bias, at a given
    point: the port's predictor against the reference's."""
    port, ref = nets
    image, _ = _inputs(b=1)
    h, w = image.shape[-2:]
    clicks = [Click(30, 20, True), Click(70, 60, False), Click(50, 41, True)]
    params = Params(with_flip=True, target_size=96)
    it = Interaction(ref, image[0, :3], params)
    ci = it.transform(clicks, image[0, 3], None)
    with torch.no_grad():
        fn = it.objective(ci, it.features(ci))
    functor = ScaleBiasOptimizer(prob_thresh=0.5, with_flip=True, min_iou_diff=1e-3)
    pred = HRNetFeatureBRSPredictor(port, opt_functor=functor, with_flip=True,
                                    net_clicks_limit=8)
    port_lists = [[PortClick(c.positive, (c.y, c.x)) for c in cl] for cl in ci.clicks_lists]
    for cl in port_lists:
        for i, c in enumerate(cl):
            c.indx = i
    hp, wp = pad_hw(h, w)
    with torch.no_grad():
        pred.input_data = port.get_head_input(pad_to(ci.image, hp, wp),
                                              pred._get_points_nd(port_lists), "A")
    pos, neg = click_maps_from_points(map_points(port_lists, "cpu"), hp, wp)
    port_fn = pred.objective(pos, neg, hp, wp, w, 1)
    g = torch.Generator().manual_seed(5)
    x = 0.2 * torch.randn(2 * pred.num_channels, generator=g)
    values = []
    for f in (port_fn, fn):
        xx = x.clone().requires_grad_()
        loss = f(xx)[0]
        grad, = torch.autograd.grad(loss, xx)
        values.append((float(loss.detach()), grad))
    (lp, gp), (lr, gr) = values
    assert abs(lp - lr) < 1e-5 * max(1.0, abs(lr))
    assert float((gp - gr).abs().max()) < 1e-4 * float(gr.abs().max())


def _click_pass(target=64):
    """Two clicks on object 1 and one on object 2 through the click
    event's program (ClickInteraction over the port's ClickController:
    f-BRS-B with flip, the zoom-in after the first click, the device
    drive) on a 96x96 frame, the zoom-in's target cut to 64 for the CPU's
    time."""
    from types import SimpleNamespace

    click = kind("click")
    block = {"model": dict(MODEL), "predictor": {
        "brs_mode": "f-BRS-B", "prob_thresh": 0.5, "net_clicks_limit": 8,
        "max_size": 800, "with_flip": True,
        "zoom_in": {"skip_clicks": 1, "target_size": target, "expansion_ratio": 1.4},
        "min_iou_diff": 1e-3, "maxfun": 20, "host_lbfgs": False}, "network_seed": CLICK_SEED}
    st = click.setup({"click": block}, 0, torch.device("cpu"))
    rng = np.random.default_rng(0)
    truth = np.zeros((96, 96), np.uint8)
    truth[20:60, 15:55] = 1
    truth[65:90, 60:90] = 2
    image = (rng.random((96, 96, 3)) * 120 + 60 * (truth[..., None] == 1)).astype(np.uint8)
    frame = SimpleNamespace(setup={"click": st}, image=image, i=0,
                            video=SimpleNamespace(num_objects=2, mask=lambda i: truth),
                            give=lambda mask, objects: None)
    core = SimpleNamespace(state=None, object_manager=SimpleNamespace(all_obj_ids=[]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        click.program(core, {"objects": [1, 2], "clicks": 2}, frame)
    return click, st, block, prof


@pytest.fixture(scope="module")
def click_pass(nets):
    return _click_pass()


def test_click_controller_pass_against_the_reference(click_pass):
    """Each click's probabilities from the reference at the program's own
    clicks, previous mask and the drive's best point (its own zoom-in
    crop from the program's previous probabilities): to 1e-5; the second
    click is zoomed and optimised."""
    click, st, block, _ = click_pass
    rec = st.records[0]
    params = click.reference_params(block)
    net = click.reference_net(block, CLICK_SEED, "cpu")
    rows = []
    for s, n, fn, probs_at in click._replay(net, rec, params, "cpu"):
        x = click._x(s["x"], 2 * click.params_channels(net), "cpu")
        gap = float((probs_at(x) - torch.from_numpy(s["out"])).abs().max())
        rows.append((n, gap, s["exit"], probs_at.__defaults__[1].zoom_roi))
    assert [r[0] for r in rows] == [1, 2, 1, 2]
    assert max(r[1] for r in rows) < 1e-5, rows
    # the second click of object 1 ran the drive inside the zoom-in's crop
    assert rows[1][2] is not None and rows[1][3] is not None, rows


def test_click_spans_nest_and_count_the_evaluations(click_pass):
    """One cutie.ritm.click span a click; the drive and zoom-in inside it;
    one ritm.brs.evaluate a forward and backward: the drive's
    evaluations and its start point's."""
    _, st, _, prof = click_pass
    # the profiler's raw events (prof.events() builds the whole op tree)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len("cutie."):])
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("cutie.ritm."))
    clicks = [s for s in spans if s[2] == "ritm.click"]
    assert len(clicks) == 4
    for start, end, name in spans:
        if name != "ritm.click":
            assert any(c0 <= start and end <= c1 for c0, c1, _ in clicks), name
    names = [s[2] for s in spans]
    steps = [s for o in st.records[0]["objects"] for s in o["steps"]]
    drives = [s for s in steps if s["exit"] is not None]
    assert names.count("ritm.lbfgs.drive") == len(drives) == 2
    assert names.count("ritm.brs.evaluate") == sum(s["evals"] + 1 for s in drives)
    assert names.count("ritm.backbone") == 4 and names.count("ritm.zoom_in") >= 4
