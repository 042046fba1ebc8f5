"""The port's GUI (cutie_tpu_torch/gui/) against cutie_tpu's on the CPU.

- Every visualization mode, mask- and probability-based, with and without
  a layer: bit-equal.
- ClickInteraction over NoBRS click controllers on the RITM golden
  weights (the zoom-in cut to 64 px, as tests/test_torch_ritm_click.py
  does): the controllers' object probabilities within 1e-6 (measured
  1.2e-7, one ulp at 0.5), and predict() bit-equal on the same object
  probabilities. On each side's own, predict() has the same argmax and is
  within 1e-3 (measured 2.1e-4): the random weights leave the object's
  probability within 0.05 of 0.5 at every pixel, a near tie with the
  background, and the x1000 temperature multiplies the one-ulp difference.
- A MainController on each side over the same 6-frame workspace
  (stream_small_work.npz, the small model, mem_every 3): import_mask,
  on_propagate forward, on_commit, on_propagate backward. Every saved
  frame's probabilities at tests/test_torch_stream.py's bars, the saved
  masks' agreement > 0.97 a frame, equal gauges after every step, and
  equal visualization files where the masks are equal.
- ResourceManager's images path with a shorter-edge cap (frames equal to
  the cv2-written ones: at 2x bit for bit, at 1.5x within resize_area's
  one level), video ingest from a small mp4 written with cv2, mask and
  layer import, binary-mask export (equal PNGs) and video export (a
  readable mp4 through cv2; an ImportError naming PyAV and cv2 when both
  are blocked).
- The view protocol: the widget layers' controller references (AST), the
  refresh protocol, the soft-mask toggle, update_memory_config reaching the
  processor; the Qt and tk windows where PySide6 or a display exists.

cutie_tpu's click controller is replaced by a stand-in where no click is
made, so that no test compiles cutie_tpu's HRNet for nothing, and no test
reaches its on-device L-BFGS.
"""
import ast
import importlib
import inspect
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
from PIL import Image  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import _assert_stream_close, one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.config import Config, eval_config  # noqa: E402
from cutie_tpu_torch.gui import interactive_utils, resource_manager  # noqa: E402
from cutie_tpu_torch.gui.interaction import ClickInteraction  # noqa: E402
from cutie_tpu_torch.gui.main_controller import MainController  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import build_model  # noqa: E402
from cutie_tpu_torch.utils.palette import davis_palette  # noqa: E402

MODES = ("davis", "fade", "light", "popup", "layer", "rgba", "mask", "image")
SETTINGS = {"mem_every": 3, "top_k": 30, "stagger_updates": 5,
            "max_mem_frames": 3, "use_long_term": False, "max_internal_size": -1}


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """cutie_tpu's computations synchronous, as in tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_gui_headless.py's workspace: the first 6 frames of
    stream_small_work.npz as PNGs and its first mask as a palette PNG."""
    rec = dict(np.load(require_golden("stream_small_work.npz")))
    root = tmp_path_factory.mktemp("ws")
    img_dir = root / "frames"
    os.makedirs(img_dir)
    for ti, f in enumerate(rec["frames"][:6]):
        arr = (np.transpose(f, (1, 2, 0)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{ti:05d}.png")
    m = Image.fromarray(rec["mask0"].astype(np.uint8), mode="P")
    m.putpalette(davis_palette)
    m.save(root / "gt.png")
    return root, rec


def _gui_cfg(root, name, **extra):
    return dict({"images": str(root / "frames"), "video": None,
                 "workspace": str(root / name), "num_objects": 2,
                 "buffer_size": 20, "save_queue_size": 20, "num_save_threads": 2,
                 "max_overall_size": -1, "max_internal_size": -1, "mem_every": 3,
                 "use_long_term": False, "output_fps": 10}, **extra)


@pytest.fixture(scope="module")
def port_bundle():
    cfg = eval_config("small")
    cfg.merge(SETTINGS)
    return build_model(cfg, str(require_golden("state_dict_small.npz")), device="cpu"), cfg


def _port_controller(root, name, bundle, **extra):
    return MainController(Config(_gui_cfg(root, name, **extra)), bundle=bundle,
                          click_ckpt=None, device="cpu")


class _NoClicks:
    """Stands in for cutie_tpu's ClickController where no click is made."""

    def __init__(self, *args, **kwargs):
        pass

    def unanchor(self):
        pass


def _jax_controller(root, name, monkeypatch):
    """cutie_tpu's MainController on the small golden weights at SETTINGS
    (tests/test_inference_stream.py:_build_core's model)."""
    import jax.numpy as jnp

    from cutie_tpu.config import Config as JaxConfig
    from cutie_tpu.config import eval_config as jax_eval_config
    from cutie_tpu.gui import main_controller as jax_main
    from cutie_tpu.models import CUTIE
    from cutie_tpu.utils.get_default_model import ModelBundle
    from cutie_tpu.utils.weight_import import convert_torch_state_dict

    monkeypatch.setattr(jax_main, "ClickController", _NoClicks)
    sd = {k: v.astype(np.float32)
          for k, v in np.load(require_golden("state_dict_small.npz")).items()}
    cfg = jax_eval_config("small")
    cfg.merge(SETTINGS)
    model = CUTIE(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2, 64, 64)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    bundle = ModelBundle(model=model, cfg=cfg,
                         variables=convert_torch_state_dict(sd, zeros, strict=True))
    return jax_main.MainController(JaxConfig(_gui_cfg(root, name)), bundle=bundle,
                                   click_ckpt=None)


# ------------------------------------------------------------ visualizations

@pytest.mark.parametrize("mode", MODES)
def test_visualization_modes_bit_equal(mode):
    from cutie_tpu.gui import interactive_utils as theirs

    rng = np.random.default_rng(MODES.index(mode))
    image = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    mask = rng.integers(0, 4, (24, 40))
    prob = rng.random((4, 24, 40)).astype(np.float32)
    prob /= prob.sum(0, keepdims=True)
    layer = rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)
    for lay in (None, layer):
        for targets in ([1, 2, 3], [2], []):
            np.testing.assert_array_equal(
                interactive_utils.get_visualization(mode, image, mask, lay, targets),
                theirs.get_visualization(mode, image, mask, lay, targets))
            np.testing.assert_array_equal(
                interactive_utils.get_visualization_prob(
                    mode, image.astype(np.float32) / 255, prob, lay, targets),
                theirs.get_visualization_prob(
                    mode, image.astype(np.float32) / 255, prob, lay, targets))


# ------------------------------------------------------------------- clicks

def test_click_interaction_matches_cutie_tpu(workspace):
    import jax.numpy as jnp

    from cutie_tpu.gui.interaction import ClickInteraction as JaxInteraction
    from cutie_tpu.ritm.inference import InteractiveController as JaxController
    from cutie_tpu.ritm.model import HRNetISModel as FlaxModel
    from cutie_tpu.ritm.utils import ClickController as JaxClicks
    from cutie_tpu.ritm.weight_import import convert_ritm_state_dict

    from cutie_tpu_torch.ritm.inference import InteractiveController
    from cutie_tpu_torch.ritm.utils import ClickController
    from tests.test_torch_ritm_click import HRNET, ZOOM

    params = {"brs_mode": "NoBRS", "prob_thresh": 0.5, "net_clicks_limit": 8,
              "max_size": 800, "with_flip": True, "zoom_in_params": ZOOM}
    sd_path = str(require_golden("ritm_state_dict.npz"))
    ours = ClickController(sd_path, brs_mode="NoBRS", device="cpu")
    ours.controller = InteractiveController(ours.model, params)
    flax_model = FlaxModel(**HRNET)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 4)), jnp.full((1, 2, 3), -1.0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables = convert_ritm_state_dict(dict(np.load(sd_path)), zeros, strict=True)
    theirs = JaxClicks.__new__(JaxClicks)
    theirs.controller = JaxController(flax_model, variables, params)
    theirs.anchored = False

    root, rec = workspace
    image = np.ascontiguousarray(rec["frames"][0])
    from cutie_tpu_torch.ops.tensor_utils import aggregate_wbg_np
    one_hot = np.stack([(rec["mask0"] == i).astype(np.float32) for i in (1, 2)])
    prev = aggregate_wbg_np(one_hot, keep_bg=True, hard=True)
    mine = ClickInteraction(image, prev, image.shape[1:], ours, 1)
    ref = JaxInteraction(image, prev, image.shape[1:], theirs, 1)
    for x, y, neg in ((60, 40, False), (20, 70, True), (100, 30, False)):
        mine.push_point(x, y, neg)
        ref.push_point(x, y, neg)
        assert mine.pos_clicks == ref.pos_clicks and mine.neg_clicks == ref.neg_clicks
        np.testing.assert_allclose(mine.obj_mask, ref.obj_mask, rtol=0, atol=1e-6)
        a, b = mine.predict(), ref.predict()
        np.testing.assert_array_equal(a.argmax(0), b.argmax(0))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        own = mine.obj_mask
        mine.obj_mask = ref.obj_mask
        np.testing.assert_array_equal(mine.predict(), b)
        mine.obj_mask = own


# ------------------------------------------------------------------ session

def _record_saves(ctl):
    """Every save_current_mask's (frame, probabilities), in call order."""
    saves = []
    original = ctl.save_current_mask

    def save():
        saves.append((ctl.curr_ti, ctl.curr_prob.copy()))
        original()

    ctl.save_current_mask = save
    return saves


def test_controller_session_matches_cutie_tpu(workspace, port_bundle, monkeypatch):
    root, rec = workspace
    ours = _port_controller(root, "port", port_bundle)
    theirs = _jax_controller(root, "jax", monkeypatch)
    assert (ours.T, ours.h, ours.w) == (theirs.T, theirs.h, theirs.w) == (6, 96, 128)
    saves = [_record_saves(ours), _record_saves(theirs)]
    steps = (("import_mask", (str(root / "gt.png"),)), ("on_propagate", ("forward",)),
             ("on_commit", ()), ("on_propagate", ("backward",)))
    for name, args in steps:
        for ctl in (ours, theirs):
            getattr(ctl, name)(*args)
        assert ours.get_memory_gauges() == theirs.get_memory_gauges(), name
        assert ours.curr_ti == theirs.curr_ti, name
    assert ours.get_memory_gauges()["permanent"] == 2 * 6 * 8   # two commits' tokens
    ours.close()
    theirs.close()

    assert [ti for ti, _ in saves[0]] == [ti for ti, _ in saves[1]]
    assert len(saves[0]) == 1 + 6 + 6
    _assert_stream_close([p for _, p in saves[0]], [p for _, p in saves[1]])
    for ti in range(6):
        name = f"{ti:05d}.png"
        mine = np.array(Image.open(root / "port" / "masks" / name))
        ref = np.array(Image.open(root / "jax" / "masks" / name))
        assert (mine == ref).mean() > 0.97, ti
        vis = (root / "port" / "visualization" / "davis" / f"{ti:05d}.jpg",
               root / "jax" / "visualization" / "davis" / f"{ti:05d}.jpg")
        if (mine == ref).all():
            assert vis[0].read_bytes() == vis[1].read_bytes(), ti


# --------------------------------------------------------- resource manager

def _resource_managers(root, name, **cfg):
    from cutie_tpu.gui.resource_manager import ResourceManager as JaxResources

    both = []
    for side, cls in (("port", resource_manager.ResourceManager), ("jax", JaxResources)):
        c = dict({"images": None, "video": None, "workspace": str(root / f"{name}_{side}"),
                  "num_objects": 1, "buffer_size": 4, "save_queue_size": 4,
                  "num_save_threads": 1}, **cfg)
        both.append(cls(c))
    return both


@pytest.mark.parametrize("ext,size,cap", [(".jpg", (64, 96), 32), (".png", (48, 72), 32)])
def test_images_capped_like_cv2(tmp_path, ext, size, cap):
    """The shorter edge capped at `cap`: 2x (JPEG sources, re-encoded at
    quality 95: equal bytes) and 1.5x (PNG sources: within one level)."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(len(ext))
    for ti in range(3):
        img = cv2.GaussianBlur(rng.integers(0, 256, size + (3,), dtype=np.uint8), (5, 5), 2)
        Image.fromarray(img).save(src / f"{ti:05d}{ext}", quality=90)
    ours, theirs = _resource_managers(tmp_path, "cap", images=str(src), max_overall_size=cap)
    assert ours.T == theirs.T == 3 and (ours.h, ours.w) == (theirs.h, theirs.w)
    assert min(ours.h, ours.w) == cap
    for ti in range(3):
        a, b = ours.get_image(ti).astype(int), theirs.get_image(ti).astype(int)
        if ext == ".jpg":
            name = f"{ti:05d}.jpg"
            assert (tmp_path / "cap_port" / "images" / name).read_bytes() == \
                (tmp_path / "cap_jax" / "images" / name).read_bytes()
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= 1
    ours.close()
    theirs.close()


def test_video_ingest(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    video = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for _ in range(5):
        writer.write(cv2.GaussianBlur(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
                                      (5, 5), 2))
    writer.release()
    ours, theirs = _resource_managers(tmp_path, "vid", video=video, max_overall_size=24)
    assert ours.T == theirs.T == 5 and (ours.h, ours.w) == (24, 32)
    for ti in range(5):
        name = f"{ti:07d}.jpg"
        assert (tmp_path / "vid_port" / "images" / name).read_bytes() == \
            (tmp_path / "vid_jax" / "images" / name).read_bytes()
        np.testing.assert_array_equal(ours.get_image(ti), theirs.get_image(ti))
    ours.close()
    theirs.close()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        resource_manager.ResourceManager({
            "images": None, "video": video, "workspace": str(tmp_path / "vid_none"),
            "num_objects": 1, "buffer_size": 4, "save_queue_size": 4,
            "num_save_threads": 1, "max_overall_size": -1})


def test_import_mask_and_layer(tmp_path):
    rng = np.random.default_rng(2)
    src = tmp_path / "src"
    src.mkdir()
    Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(src / "0.png")
    mask = Image.fromarray(rng.integers(0, 3, (45, 70)).astype(np.uint8), mode="P")
    mask.putpalette(davis_palette)
    mask.save(tmp_path / "mask.png")
    rgba = rng.integers(0, 256, (50, 33, 4), dtype=np.uint8)
    rgba[..., 3][rng.random((50, 33)) < 0.3] = 0
    Image.fromarray(rgba, "RGBA").save(tmp_path / "layer.png")
    Image.fromarray(rgba[..., :3]).save(tmp_path / "layer.jpg")
    ours, theirs = _resource_managers(tmp_path, "imp", images=str(src), max_overall_size=-1)
    np.testing.assert_array_equal(ours.import_mask(str(tmp_path / "mask.png"), (30, 40)),
                                  theirs.import_mask(str(tmp_path / "mask.png"), (30, 40)))
    for name in ("layer.png", "layer.jpg"):
        np.testing.assert_array_equal(ours.import_layer(str(tmp_path / name), (30, 40)),
                                      theirs.import_layer(str(tmp_path / name), (30, 40)))
    ours.close()
    theirs.close()


def test_exports(tmp_path, monkeypatch):
    from cutie_tpu.gui import exporter as jax_exporter

    from cutie_tpu_torch.gui import exporter

    rng = np.random.default_rng(3)
    masks = tmp_path / "masks"
    masks.mkdir()
    for ti in range(4):
        m = Image.fromarray(rng.integers(0, 4, (20, 30)).astype(np.uint8), mode="P")
        m.putpalette(davis_palette)
        m.save(masks / f"{ti:05d}.png")
    exporter.convert_mask_to_binary(str(masks), str(tmp_path / "bin_port"), [1, 3])
    jax_exporter.convert_mask_to_binary(str(masks), str(tmp_path / "bin_jax"), [1, 3])
    for ti in range(4):
        a = Image.open(tmp_path / "bin_port" / f"{ti:05d}.png")
        b = Image.open(tmp_path / "bin_jax" / f"{ti:05d}.png")
        assert a.mode == b.mode == "L"
        np.testing.assert_array_equal(np.array(a), np.array(b))

    frames = tmp_path / "vis"
    frames.mkdir()
    for ti in range(6):
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(
            frames / f"{ti:05d}.jpg")
    progress = []
    monkeypatch.setitem(sys.modules, "av", None)   # cv2's writer where PyAV is installed
    out = tmp_path / "out.mp4"
    assert exporter.convert_frames_to_video(str(frames), str(out), fps=10, bitrate_mbps=2,
                                            progress_callback=progress.append)
    assert progress and out.stat().st_size > 1000
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    cap.release()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="PyAV.*cv2"):
        exporter.convert_frames_to_video(str(frames), str(tmp_path / "x.mp4"))


# -------------------------------------------------------------- view layers

@pytest.mark.parametrize("module_name", ["widgets", "tk_widgets"])
def test_view_protocol_contract(module_name):
    """Every `controller.<name>` a widget layer references exists on the
    port's MainController (tests/test_gui_headless.py's check)."""
    module = importlib.import_module(f"cutie_tpu_torch.gui.{module_name}")
    tree = ast.parse(inspect.getsource(module))
    referenced = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and (
                (isinstance(node.value, ast.Name) and node.value.id == "controller")
                or (isinstance(node.value, ast.Attribute)
                    and node.value.attr == "controller")):
            referenced.add(node.attr)
    assert len(referenced) > 20, referenced
    members = set(dir(MainController))
    init_src = inspect.getsource(MainController.__init__)
    for node in ast.walk(ast.parse(init_src.lstrip())):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            members.add(node.attr)
    assert not referenced - members, referenced - members


def test_refresh_protocol_and_memory_settings(workspace, port_bundle):
    """view.refresh(controller) on every state change; the soft-mask
    toggle; update_memory_config reaching the processor, the ring grown."""
    root, rec = workspace

    class MockView:
        refreshes = 0

        def refresh(self, controller):
            self.refreshes += 1
            assert 0 <= controller.curr_ti < controller.T
            assert set(controller.get_memory_gauges()) == {
                "permanent", "working", "working_max", "long_term", "long_term_max"}
            assert controller.visualize().shape[:2] == (controller.h, controller.w)

    ctl = _port_controller(root, "view", port_bundle)
    view = MockView()
    ctl.view = view
    ctl.load_frame(1)
    ctl.set_vis_mode("fade")
    ctl.on_clear_memory()
    assert view.refreshes == 3

    calls = []
    ctl.res_man.save_soft_mask = lambda ti, prob: calls.append(ti)
    assert ctl.save_soft_mask is False
    ctl.save_current_mask()
    assert calls == []
    ctl.on_save_soft_mask_toggle(True)
    ctl.save_current_mask()
    assert calls == [ctl.curr_ti]

    ctl.import_mask(str(root / "gt.png"))
    ctl.on_propagate("forward", max_frames=2)
    assert ctl.processor.state.work_key.shape[1] == 2
    ctl.update_memory_config(mem_every=2, max_mem_frames=6)
    assert ctl.processor.mem_every == 2
    assert ctl.processor.max_mem_frames == 5 and ctl.processor.ring_frames == 5
    assert ctl.processor.state.work_key.shape[1] == 5
    ctl.close()


def test_controller_needs_the_card_unless_asked(workspace, port_bundle):
    root, rec = workspace
    assert inspect.signature(MainController).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MainController(Config(_gui_cfg(root, "nocard")), bundle=port_bundle)


def test_qt_offscreen_smoke(workspace, port_bundle):
    pytest.importorskip("PySide6")
    os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
    from PySide6.QtWidgets import QApplication

    from cutie_tpu_torch.gui.widgets import GUI

    root, rec = workspace
    ctl = _port_controller(root, "qt", port_bundle)
    app = QApplication.instance() or QApplication([])  # noqa: F841
    gui = GUI(ctl, ctl.cfg)
    gui.text_to_console("hello")
    assert "hello" in gui.console.toPlainText()
    gui.mem_every_box.setValue(2)
    gui._on_memory_param_change()
    assert ctl.processor.mem_every == 2
    gui.close()


def test_tk_window_smoke(workspace, port_bundle):
    from cutie_tpu_torch.gui import tk_widgets

    if not tk_widgets.tk_display_available():
        pytest.skip("no X display (tkinter cannot open a window)")
    root, rec = workspace
    ctl = _port_controller(root, "tk", port_bundle)
    gui = tk_widgets.TkGUI(ctl, ctl.cfg)
    gui.text_to_console("hello")
    assert "hello" in gui.console.get("1.0", "end")

    class E:
        x, y = 10, 10
    gui._click(E, False)
    assert ctl.interaction is not None
    gui.mem_every_box.delete(0, "end")
    gui.mem_every_box.insert(0, "2")
    gui._on_memory_param_change()
    assert ctl.processor.mem_every == 2
    gui._on_close()


def test_interactive_demo_workspace_init(workspace, tmp_path):
    """python -m cutie_tpu_torch.interactive_demo --workspace_init_only on
    the CPU builds the workspace at the demo's GUI config."""
    from cutie_tpu_torch import interactive_demo

    root, rec = workspace
    args = interactive_demo.parse_args(["--images", str(root / "frames"),
                                        "--workspace", str(tmp_path / "ws"),
                                        "--device", "cpu", "--num_objects", "2"])
    cfg = interactive_demo.gui_config(args)
    assert (cfg.amp, cfg.use_long_term, cfg.mem_every, cfg.max_internal_size) == \
        (True, True, 5, 480)
    assert args.device == "cpu" and interactive_demo.parse_args([]).device == "cuda"
    interactive_demo.main(["--images", str(root / "frames"), "--workspace",
                           str(tmp_path / "ws"), "--device", "cpu",
                           "--workspace_init_only"])
    assert sorted(os.listdir(tmp_path / "ws" / "images")) == \
        [f"{ti:05d}.png" for ti in range(6)]
