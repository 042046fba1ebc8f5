"""The port's software-rendered GUI session
(cutie_tpu_torch/tools/render_gui_session.py) against the reference tool
(tools/render_gui_session.py, loaded by path; its main is never called, so
docs/assets/gui_session.png is never written):

  - image_io.resize_bicubic bit-equal to Pillow's Image.resize(...,
    Image.BICUBIC), the default filter the reference's resizes take, over
    seeded up- and down-sizes of RGB and L images;
  - SoftwareView.refresh on one stub controller: the images bit-equal
    outside the text boxes (the port draws its own 5x8 font where the
    reference draws Pillow's default font), the union of both renderers'
    boxes grown by one pixel;
  - a CPU run of the port's main into tmp_path: the reference recording's
    storyboard size and panel count, read back through image_io.read_png.
"""
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.tools import render_gui_session as port_tool  # noqa: E402
from cutie_tpu_torch.utils.image_io import (read_png, resize_bicubic,  # noqa: E402
                                            resize_bilinear)

REPO = Path(__file__).resolve().parent.parent
REFERENCE_BOARD = REPO / "docs" / "assets" / "gui_session.png"


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_render_gui_session", REPO / "tools" / "render_gui_session.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_resize_bicubic_matches_pillow(mode):
    """Up, down and mixed sizes (the GUI canvas's 96x128 -> 360x640 and its
    minimap's 360x640 -> 123x220 among them); resize_bilinear again beside
    it, which shares the passes."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0 if mode == "RGB" else 1)
    sizes = [((96, 128), (360, 640)), ((360, 640), (123, 220)), ((1, 7), (5, 1))]
    sizes += [(tuple(rng.integers(1, 80, 2)), tuple(rng.integers(1, 160, 2)))
              for _ in range(40)]
    for (h, w), (oh, ow) in sizes:
        shape = (h, w, 3) if mode == "RGB" else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        pil = Image.fromarray(img, mode)
        np.testing.assert_array_equal(resize_bicubic(img, oh, ow),
                                      np.asarray(pil.resize((int(ow), int(oh)))))
        np.testing.assert_array_equal(resize_bilinear(img, oh, ow),
                                      np.asarray(pil.resize((int(ow), int(oh)),
                                                            Image.BILINEAR)))


class _StubController:
    """What SoftwareView reads of a MainController."""

    def __init__(self, seed, curr_ti, gauges):
        rng = np.random.default_rng(seed)
        self.vis = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
        self.vis[20:50, 30:70] = (200, 30, 40)
        self.curr_ti, self.T = curr_ti, 6
        self.gauges = gauges
        self.curr_object, self.vis_mode = 2, "davis"

    def visualize(self):
        return self.vis

    def get_memory_gauges(self):
        return self.gauges


def _text_mask(shape, boxes):
    mask = np.zeros(shape[:2], bool)
    for x0, y0, x1, y1 in boxes:
        mask[max(y0 - 1, 0):y1 + 2, max(x0 - 1, 0):x1 + 2] = True
    return mask


@pytest.mark.parametrize("curr_ti,gauges", [
    (0, {"permanent": 0, "working": 0, "working_max": 2, "long_term": 0,
         "long_term_max": 0}),
    (4, {"permanent": 48, "working": 1, "working_max": 2, "long_term": 7,
         "long_term_max": 9}),
])
def test_refresh_matches_reference_view(curr_ti, gauges, monkeypatch):
    pytest.importorskip("PIL")
    from PIL import ImageDraw

    ref = _reference_tool()
    ref_boxes = []
    draw_text = ImageDraw.ImageDraw.text

    def recording_text(self, xy, text, *args, **kwargs):
        ref_boxes.append(tuple(int(v) for v in self.textbbox(xy, text)))
        return draw_text(self, xy, text, *args, **kwargs)

    monkeypatch.setattr(ImageDraw.ImageDraw, "text", recording_text)
    ctl = _StubController(curr_ti, curr_ti, gauges)
    views = ref.SoftwareView(), port_tool.SoftwareView()
    for view in views:
        view.label = "propagate forward"
        for line in ("session start", "click +(30,20) obj1", "x" * 50):
            view.text_to_console(line)
        view.refresh(ctl)
    want = np.asarray(views[0].frames[-1][1])
    got = views[1].frames[-1][1]
    assert got.shape == want.shape == (port_tool.WIN_H, port_tool.WIN_W, 3)
    assert got.dtype == np.uint8
    assert len(ref_boxes) == len(views[1].text_boxes[-1])
    outside = ~_text_mask(got.shape, ref_boxes + views[1].text_boxes[-1])
    assert outside.mean() > 0.9
    np.testing.assert_array_equal(got[outside], want[outside])
    assert (got[~outside] == np.asarray(port_tool.TEXT, np.uint8)).all(-1).any()


def test_main_cpu_run_gives_the_reference_storyboard(tmp_path):
    """The port's session on the CPU (the reference tool's own session:
    cutie-small on the golden weights, 6 frames of stream_small_work.npz):
    the reference recording's 6 panels in 3 rows, its storyboard size, a
    refresh a step of the session and one a propagated frame, and the
    committed recording untouched."""
    weights = require_golden("state_dict_small.npz")
    before = hashlib.sha256(REFERENCE_BOARD.read_bytes()).hexdigest()
    out = tmp_path / "board.png"
    res = port_tool.main(["--device", "cpu", "--workspace", str(tmp_path / "ws"),
                          "--out", str(out), "--weights", str(weights)])
    assert res["out"] == str(out) and res["panels"] == 6
    assert res["labels"].count("propagate forward") == 5     # frames 1-5
    assert res["refreshes"] == 9
    board, mode, _ = read_png(str(out))
    reference, _, _ = read_png(str(REFERENCE_BOARD))
    assert board.shape == reference.shape and mode == "RGB"
    assert (board.shape[0] - 6) // (port_tool.WIN_H + 18) == 3
    assert hashlib.sha256(REFERENCE_BOARD.read_bytes()).hexdigest() == before
    with pytest.raises(FileExistsError):
        port_tool.main(["--device", "cpu", "--workspace", str(tmp_path / "ws")])
