"""The port's RITM model (cutie_tpu_torch.ritm) on the CPU: HRNet-18/OCR-64
and DeepLabV3+ against the reference's recorded forwards, the weights
against cutie_tpu's importer, the click encodings (torch and the host C++
library) against cutie_tpu's, the training losses and AdaptiveIoU against
the reference's, and model loading.

Tolerances: the forwards as tests/test_ritm.py holds cutie_tpu (rtol 2e-3,
atol 5e-3; DeepLab's atol scaled by the logits' magnitude, at least 1);
weights exactly; click maps exactly (disks) or to 1e-6 (tanh: the same
fp32 operations; the C++ BFS against the vectorised path to 1e-3, as
tests/test_ritm.py does); losses to 1e-5 and AdaptiveIoU to 1e-9, the bars
of tests/test_ritm.py::test_ritm_train_losses_golden.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.ritm import dist_maps  # noqa: E402
from cutie_tpu_torch.ritm import train_losses as tl  # noqa: E402
from cutie_tpu_torch.ritm.deeplab import DeepLabISModel  # noqa: E402
from cutie_tpu_torch.ritm.model import HRNetISModel  # noqa: E402
from cutie_tpu_torch.ritm.utils import ClickController, load_is_model  # noqa: E402
from cutie_tpu_torch.ritm.weight_import import (from_jax_variables,  # noqa: E402
                                                state_dict_tensors)
from cutie_tpu_torch.utils import host_build  # noqa: E402

HRNET = dict(width=18, ocr_width=64, small=False, with_prev_mask=True,
             use_disks=True, norm_radius=5, use_rgb_conv=False, use_leaky_relu=True)


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """cutie_tpu's computations synchronous, as in tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.fixture(scope="module")
def ritm_sd():
    return dict(np.load(require_golden("ritm_state_dict.npz")))


@pytest.fixture(scope="module")
def deeplab_rec():
    raw = dict(np.load(require_golden("deeplab_forward.npz")))
    sd = {k[3:]: v.astype(np.float32) for k, v in raw.items() if k.startswith("sd:")}
    return raw, sd


def _hrnet(sd, **overrides):
    model = HRNetISModel(**{**HRNET, **overrides}).eval()
    model.load_state_dict(state_dict_tensors(sd), strict=True)
    return model


def test_hrnet_forward_matches_golden(ritm_sd):
    rec = dict(np.load(require_golden("ritm_stages.npz")))
    model = _hrnet(ritm_sd)
    with torch.no_grad():
        out = model(torch.from_numpy(rec["image"]), torch.from_numpy(rec["points"]))
    np.testing.assert_allclose(out["instances"].numpy(), rec["instances"],
                               rtol=2e-3, atol=5e-3)


def test_hrnet_amp_runs_bf16_convolutions_and_returns_fp32(ritm_sd):
    """amp: every convolution in bf16 (cutie_tpu's dtype=bfloat16 model),
    the logits fp32; and the low-resolution, head-input and head-rerun
    methods compose to the forward's logits."""
    rec = dict(np.load(require_golden("ritm_stages.npz")))
    image, points = torch.from_numpy(rec["image"]), torch.from_numpy(rec["points"])
    model = _hrnet(ritm_sd, amp=True)
    dtypes = set()
    hooks = [m.register_forward_hook(lambda m, i, o: dtypes.add(o.dtype))
             for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        out = model(image, points)["instances"]
        for h in hooks:
            h.remove()
        model.amp = False
        low = model.low_res_instances(image, points)
        full = model(image, points)["instances"]
        feats = model.get_head_input(image, points, "A")
        ocr = model.get_head_input(image, points, "C")
        via_a = model.head_from_feats(feats, *image.shape[-2:], "A")
        via_c = model.head_from_feats(ocr, *image.shape[-2:], "C")
    assert dtypes == {torch.bfloat16} and out.dtype == torch.float32
    assert low.shape == (1, 1, 16, 24) and feats.shape == (1, 270, 16, 24)
    assert ocr.shape == (1, 128, 16, 24)
    np.testing.assert_array_equal(via_a.numpy(), full.numpy())
    np.testing.assert_array_equal(via_c.numpy(), full.numpy())
    # bf16 noise on the same logits (scale ~0.16)
    np.testing.assert_allclose(out.numpy(), rec["instances"], atol=2e-2)


def _flax_zeros(model, c_in=4):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, c_in)), jnp.full((1, 2, 3), -1.0))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))


@pytest.mark.parametrize("flavour", ["hrnet", "deeplab"])
def test_from_jax_variables_round_trip(flavour, ritm_sd):
    """cutie_tpu's importer over jax.eval_shape zeros, then the port's
    inverse, gives back the reference state dict exactly, and it loads
    strictly."""
    from cutie_tpu.ritm.weight_import import convert_ritm_state_dict

    if flavour == "hrnet":
        from cutie_tpu.ritm.model import HRNetISModel as FlaxModel
        flax_model, port, sd = FlaxModel(**HRNET), HRNetISModel(**HRNET), ritm_sd
    else:
        from cutie_tpu.ritm.deeplab import DeepLabISModel as FlaxModel
        shapes = dict(np.load(require_golden("deeplab_shapes.npz")))
        rng = np.random.default_rng(0)
        sd = {k: rng.standard_normal(tuple(v)).astype(np.float32)
              for k, v in shapes.items()}
        flax_model, port = FlaxModel(), DeepLabISModel()
    variables = convert_ritm_state_dict(sd, _flax_zeros(flax_model), strict=True)
    back = from_jax_variables(variables, port)
    want = state_dict_tensors(sd)
    assert set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k
    port.load_state_dict(back, strict=True)


def test_hrnet_variant_matches_cutie_tpu():
    """The variants the shipped checkpoint does not use, on seeded random
    weights against cutie_tpu's forward: small HRNet, rgb_conv in place of
    maps_transform, ReLU, tanh click maps, the aux output."""
    from cutie_tpu.ritm.model import HRNetISModel as FlaxModel
    from cutie_tpu.ritm.weight_import import convert_ritm_state_dict

    cfg = dict(width=18, ocr_width=64, small=True, with_prev_mask=True, use_disks=False,
               norm_radius=5, use_rgb_conv=True, use_leaky_relu=False)
    torch.manual_seed(0)
    port = HRNetISModel(**cfg, with_aux_output=True).eval()
    rng = np.random.default_rng(4)
    sd = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in port.state_dict().items()}
    sd.update({k: np.abs(v) + 0.5 for k, v in sd.items() if k.endswith("running_var")})
    port.load_state_dict(state_dict_tensors(sd), strict=True)
    flax_model = FlaxModel(**cfg, with_aux_output=True)
    variables = convert_ritm_state_dict(sd, _flax_zeros(flax_model), strict=True)
    image = rng.random((1, 4, 48, 80)).astype(np.float32)
    points = POINTS[:1] * 1.5
    with torch.no_grad():
        ours = port(torch.from_numpy(image), torch.from_numpy(points))
    theirs = jax.jit(flax_model.apply)(variables, np.transpose(image, (0, 2, 3, 1)), points)
    for key in ("instances", "instances_aux"):
        want = np.asarray(theirs[key])[..., 0]
        np.testing.assert_allclose(ours[key][:, 0].numpy(), want, rtol=2e-3,
                                   atol=5e-3 * max(1.0, np.abs(want).max()), err_msg=key)


POINTS = np.array([[[8, 10, 0], [20.4, 30.6, 1], [-1, -1, -1],
                    [25, 3, 2], [-1, -1, -1], [-1, -1, -1]],
                   [[-1, -1, -1], [-1, -1, -1], [-1, -1, -1],
                    [31, 39, 0], [0, 0, 1], [-1, -1, -1]]], np.float32)


@pytest.mark.parametrize("use_disks,scale", [(True, 1.0), (False, 1.0), (False, 0.5)])
def test_encode_clicks_matches_cutie_tpu(use_disks, scale):
    from cutie_tpu.ritm.dist_maps import encode_clicks, get_dist_maps_xla

    h, w = 32, 40
    ours = dist_maps.encode_clicks(torch.from_numpy(POINTS), h, w, norm_radius=5.0,
                                   spatial_scale=scale, use_disks=use_disks).numpy()
    theirs = np.asarray(encode_clicks(jnp.asarray(POINTS), h, w, norm_radius=5.0,
                                      spatial_scale=scale, use_disks=use_disks))
    if use_disks:
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours, theirs, atol=1e-6)
    maps = dist_maps.get_dist_maps(torch.from_numpy(POINTS), h, w, 5.0).numpy()
    for b in range(2):
        np.testing.assert_allclose(
            maps[b], np.asarray(get_dist_maps_xla(jnp.asarray(POINTS[b]), h, w, 5.0)),
            rtol=1e-6)
    assert maps[1, 0].min() == dist_maps.FAR   # no positive click in sample 1


def test_dist_maps_library_matches_both_paths():
    """The port's C++ BFS, built into _build/ under a hash of its source and
    flags, against the port's vectorised maps (on whole-pixel clicks: the
    BFS starts from the rounded click) and cutie_tpu's library."""
    from cutie_tpu.ritm.dist_maps import get_dist_maps_cpu as theirs_cpu

    lib = dist_maps.library()
    so = host_build.library_path(dist_maps.SOURCE)
    assert so.parent == host_build.BUILD_DIR and so.exists() and lib is not None
    assert so.name.startswith("dist_maps-") and so.suffix == ".so"
    assert not list(dist_maps.SOURCE.parent.glob("*.so"))   # nothing beside the source
    points = np.round(POINTS)
    for b in range(2):
        ours = dist_maps.get_dist_maps_cpu(points[b], 48, 64, 5.0)
        vec = dist_maps.get_dist_maps(torch.from_numpy(points[b:b + 1]), 48, 64, 5.0)
        np.testing.assert_allclose(ours, vec[0].numpy(), atol=1e-3)
        np.testing.assert_array_equal(ours, theirs_cpu(points[b], 48, 64, 5.0))
        np.testing.assert_array_equal(dist_maps.get_dist_maps_cpu(POINTS[b], 48, 64, 5.0),
                                      theirs_cpu(POINTS[b], 48, 64, 5.0))
    with pytest.raises(ValueError):
        dist_maps.get_dist_maps_cpu(POINTS, 48, 64, 5.0)


def test_deeplab_names_match_reference_shapes():
    shapes = {k: tuple(int(s) for s in v)
              for k, v in np.load(require_golden("deeplab_shapes.npz")).items()}
    own = {k: tuple(v.shape) for k, v in DeepLabISModel().state_dict().items()}
    assert own == shapes


def test_deeplab_forward_matches_golden(deeplab_rec):
    raw, sd = deeplab_rec
    model = DeepLabISModel().eval()
    model.load_state_dict(state_dict_tensors(sd), strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(raw["image"]),
                     torch.from_numpy(raw["points"]))["instances"].numpy()
    theirs = raw["instances"]
    scale = max(1.0, np.abs(theirs).max())
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=5e-3 * scale)


def test_train_losses_match_golden():
    rec = dict(np.load(require_golden("ritm_train_losses.npz")))
    pred, label = torch.from_numpy(rec["pred"]), torch.from_numpy(rec["label"])
    cases = {
        "nfl": tl.normalized_focal_loss_sigmoid(pred, label, alpha=0.5, gamma=2),
        "nfl_maxmult": tl.normalized_focal_loss_sigmoid(pred, label, alpha=0.5,
                                                        gamma=2, max_mult=3.0),
        "focal": tl.focal_loss_sigmoid(pred, label, alpha=0.25, gamma=2),
        "soft_iou": tl.soft_iou_loss(pred, label),
        "bce": tl.sigmoid_bce_loss(pred, label),
    }
    for name, value in cases.items():
        np.testing.assert_allclose(value.numpy(), rec[name], atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    m = tl.AdaptiveIoU(init_thresh=0.4)
    for _ in range(3):
        m.update(rec["pred"][:, 0], rec["label"][:, 0])
    np.testing.assert_allclose(m.iou_thresh, rec["aiou_thresh"], atol=1e-9)
    np.testing.assert_allclose(m.get_epoch_value(), rec["aiou_epoch"], atol=1e-9)


def test_train_loss_gradients_match_cutie_tpu():
    """The losses' gradients against jax.grad of cutie_tpu's, ignored pixels
    and the max_mult bound included (torch.minimum halves the gradient at a
    tie, as jnp.minimum does)."""
    from cutie_tpu.ritm import train_losses as jl

    rec = dict(np.load(require_golden("ritm_train_losses.npz")))
    label = rec["label"].copy()
    label[0, 0, :3] = -1
    for name in ("normalized_focal_loss_sigmoid", "focal_loss_sigmoid",
                 "soft_iou_loss", "sigmoid_bce_loss"):
        kw = {"max_mult": 3.0} if name.startswith("normalized") else {}
        pred = torch.from_numpy(rec["pred"]).requires_grad_()
        getattr(tl, name)(pred, torch.from_numpy(label), **kw).sum().backward()
        theirs = jax.grad(lambda p: getattr(jl, name)(p, jnp.asarray(label), **kw).sum())(
            jnp.asarray(rec["pred"]))
        np.testing.assert_allclose(pred.grad.numpy(), np.asarray(theirs),
                                   atol=1e-6, rtol=1e-4, err_msg=name)


def test_initializers():
    ker = tl.bilinear_upsample_kernel(2)
    row = np.array([0.25, 0.75, 0.75, 0.25], np.float32)
    np.testing.assert_allclose(ker, np.outer(row, row), atol=1e-7)
    w = tl.bilinear_init_(torch.empty(3, 3, 4, 4), 2, groups=1, in_channels=3)
    for i in range(3):
        np.testing.assert_allclose(w[i, i].numpy(), ker, atol=1e-7)
        assert float(w[i, (i + 1) % 3].abs().max()) == 0.0
    draws = [tl.xavier_gluon_init_(torch.empty(32, 16, 3, 3),
                                   torch.Generator().manual_seed(0)) for _ in range(2)]
    bound = np.sqrt(3.0 / ((16 * 9 + 32 * 9) / 2))
    assert torch.equal(draws[0], draws[1])
    assert float(draws[0].abs().max()) <= bound + 1e-6
    assert float(draws[0].abs().max()) > 0.9 * bound
    g = tl.xavier_gluon_init_(torch.empty(64, 64), torch.Generator().manual_seed(1),
                              rnd_type="gaussian", factor_type="in")
    assert abs(float(g.std()) - np.sqrt(3.0 / 64)) < 0.02
    with pytest.raises(ValueError):
        tl.xavier_gluon_init_(torch.empty(2, 2), torch.Generator(), factor_type="x")


def test_load_is_model(tmp_path, ritm_sd):
    """No path: random HRNet-18/OCR-64 from seed 0; a .pth of HRNet weights or
    the golden .npz loads strictly; a .pth whose config names DeeplabModel
    builds DeepLab and loads it strictly; a path that does not
    load raises (cutie_tpu only warns: deviation D8); the card is the
    default device."""
    a, b = load_is_model(None, "cpu"), load_is_model(None, "cpu")
    assert isinstance(a, HRNetISModel) and not a.training
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    hr = tmp_path / "hrnet.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in ritm_sd.items()},
                "config": {"class": "isegm.model.is_hrnet_model.HRNetModel",
                           "params": {"width": {"type": "builtins.int", "value": 18}}}},
               hr)
    for path in (hr, require_golden("ritm_state_dict.npz")):
        loaded = load_is_model(str(path), "cpu")
        assert torch.equal(loaded.maps_transform[0].weight,
                           torch.from_numpy(ritm_sd["maps_transform.0.weight"]))
    dl = DeepLabISModel()
    path = tmp_path / "deeplab.pth"
    torch.save({"state_dict": dl.state_dict(),
                "config": '{"class": "isegm.model.is_deeplab_model.DeeplabModel", '
                          '"params": {"deeplab_ch": {"value": 256}}}'}, path)
    model = load_is_model(str(path), "cpu")
    assert isinstance(model, DeepLabISModel)
    assert all(torch.equal(x, y) for x, y in zip(model.state_dict().values(),
                                                 dl.state_dict().values()))
    with pytest.raises(FileNotFoundError):
        load_is_model(str(tmp_path / "missing.pth"), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_is_model(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            ClickController(None)
