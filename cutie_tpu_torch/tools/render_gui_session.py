"""Software-rendered recording of an interactive GUI session.

    python -m cutie_tpu_torch.tools.render_gui_session [--out PATH]
        [--workspace DIR] [--device cpu]

The port's counterpart of tools/render_gui_session.py. SoftwareView
implements MainController's view protocol (refresh(controller) and
text_to_console) as the Qt and tk windows do, and paints the window's
layout into a numpy uint8 image on every refresh: the canvas with the live
visualization, the minimap, the console, the timeline slider, the memory
gauges and the button row, in the reference tool's regions and colours. No
Pillow: rectangles are numpy slices with Pillow's inclusive corners, text a
5x8 dot-matrix font kept here (ASCII 32-126; its glyphs are not Pillow's),
and the canvas and minimap are resized by image_io.resize_bicubic, Pillow's
default filter, bit for bit.

main() drives the reference tool's session through the port's
MainController on the card (the CPU with --device cpu): the first 6 frames
of tests/golden/stream_small_work.npz, cutie-small on
tests/golden/state_dict_small.npz with mem_every 3, a click, the imported
first mask, a forward propagation and a commit; it writes the storyboard
(the first refresh of each step, and the propagation's end) with
image_io.write_png to --out, by default gui_session.png in the workspace.
The workspace must be new or empty.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from cutie_tpu_torch.utils.image_io import resize_bicubic, write_png

REPO = Path(__file__).resolve().parents[2]

CANVAS_W, CANVAS_H = 640, 360
SIDE_W = 220
WIN_W = CANVAS_W + SIDE_W + 24
WIN_H = CANVAS_H + 150

BG = (38, 40, 46)
PANEL = (52, 55, 62)
ACCENT = (120, 180, 255)
TEXT = (225, 225, 228)
GAUGE = (90, 200, 120)
BOARD = (20, 20, 24)
WHITE = (255, 255, 255)

# ASCII 32-126, 5 columns a glyph, each a byte with the top row in bit 0
FONT_HEX = (
    "000000000000005F00000007000700147F147F14242A7F2A1223130864623649562050"
    "0008070300001C2241000041221C002A1C7F1C2A08083E080800807030000808080808"
    "000060600020100804023E5149453E00427F400072494949462141494D331814127F10"
    "27454545393C4A49493141211109073649494936464949291E00001400000040340000"
    "00081422411414141414004122140802015909063E415D594E7C1211127C7F49494936"
    "3E414141227F4141413E7F494949417F090909013E414151737F0808087F00417F4100"
    "2040413F017F081422417F404040407F021C027F7F0408107F3E4141413E7F09090906"
    "3E4151215E7F09192946264949493203017F01033F4040403F1F2040201F3F4038403F"
    "631408146303047804036159494D43007F4141410204081020004141417F0402010204"
    "4040404040000307080020545478407F284444383844444428384444287F3854545418"
    "00087E090218A4A49C787F0804047800447D40002040403D007F1028440000417F4000"
    "7C047804787C080404783844444438FC1824241818242418FC7C080404084854545424"
    "04043F44243C4040207C1C2040201C3C4030403C44281028444C9090907C4464544C44"
    "0008364100000077000000413608000201020402"
)
GLYPH_W, GLYPH_H, ADVANCE = 5, 8, 6


def _glyphs() -> np.ndarray:
    """[95, GLYPH_H, GLYPH_W] bool."""
    cols = np.frombuffer(bytes.fromhex(FONT_HEX), np.uint8).reshape(95, GLYPH_W)
    return (cols[:, None, :] >> np.arange(GLYPH_H)[None, :, None]) & 1 == 1


GLYPHS = _glyphs()


class Painter:
    """The few ImageDraw calls the view makes, on an [H, W, 3] uint8 image.
    text_boxes collects each text's box (x0, y0, x1, y1), inclusive."""

    def __init__(self, img: np.ndarray):
        self.img = img
        self.text_boxes: List[Tuple[int, int, int, int]] = []

    def _fill(self, x0, y0, x1, y1, colour):
        h, w = self.img.shape[:2]
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
        if x0 <= x1 and y0 <= y1:
            self.img[y0:y1 + 1, x0:x1 + 1] = colour

    def rectangle(self, box, fill=None, outline=None):
        """ImageDraw.rectangle: both corners inclusive; the outline one
        pixel wide over the fill, unless it is the fill's colour."""
        x0, y0, x1, y1 = (int(v) for v in box)
        if x1 < x0 or y1 < y0:
            raise ValueError(f"rectangle {box}: x1 < x0 or y1 < y0")
        if fill is not None:
            self._fill(x0, y0, x1, y1, fill)
        if outline is not None and outline != fill:
            for edge in ((x0, y0, x1, y0), (x0, y1, x1, y1), (x0, y0, x0, y1),
                         (x1, y0, x1, y1)):
                self._fill(*edge, outline)

    def text(self, xy, text: str, fill):
        """The string in the dot-matrix font, its top left at xy; characters
        outside ASCII 32-126 draw as '?'."""
        x, y = (int(v) for v in xy)
        h, w = self.img.shape[:2]
        for i, ch in enumerate(text):
            code = ord(ch) - 32 if 32 <= ord(ch) <= 126 else ord("?") - 32
            gx = x + i * ADVANCE
            ys, xs = np.nonzero(GLYPHS[code])
            ys, xs = ys + y, xs + gx
            keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
            self.img[ys[keep], xs[keep]] = fill
        if text:
            self.text_boxes.append((x, y, x + len(text) * ADVANCE - 2, y + GLYPH_H - 1))

    def paste(self, src: np.ndarray, xy):
        x, y = xy
        self.img[y:y + src.shape[0], x:x + src.shape[1]] = src


def _canvas(h, w, colour) -> np.ndarray:
    img = np.empty((h, w, 3), np.uint8)
    img[:] = colour
    return img


class SoftwareView:
    """MainController's view: paints the window's layout on every refresh
    (the protocol of gui/widgets.py and gui/tk_widgets.py). frames holds
    (label, image) for each refresh, text_boxes each refresh's text boxes."""

    BUTTONS = ("Fwd", "Bwd", "Stop", "Commit", "Clear", "Clear-NP",
               "Reset", "Undo", "Export")

    def __init__(self):
        self.console_lines: List[str] = []
        self.frames: List[Tuple[str, np.ndarray]] = []
        self.text_boxes: List[List[Tuple[int, int, int, int]]] = []
        self.label = ""

    def text_to_console(self, text):
        self.console_lines.append(str(text))

    def refresh(self, controller):
        img = _canvas(WIN_H, WIN_W, BG)
        d = Painter(img)

        # canvas: the live visualization
        vis = np.ascontiguousarray(controller.visualize()[..., :3], np.uint8)
        canvas = resize_bicubic(vis, CANVAS_H, CANVAS_W)
        d.paste(canvas, (8, 8))
        d.rectangle([7, 7, 8 + CANVAS_W, 8 + CANVAS_H], outline=ACCENT)

        sx = CANVAS_W + 16
        # minimap
        mini = resize_bicubic(canvas, SIDE_W * CANVAS_H // CANVAS_W, SIDE_W)
        d.paste(mini, (sx, 8))
        d.rectangle([sx - 1, 7, sx + SIDE_W, 8 + mini.shape[0]], outline=ACCENT)

        # console (the last lines)
        cy = 16 + mini.shape[0]
        d.rectangle([sx - 1, cy, sx + SIDE_W, CANVAS_H + 8], fill=PANEL)
        for i, line in enumerate(self.console_lines[-14:]):
            d.text((sx + 4, cy + 4 + 12 * i), line[:34], fill=TEXT)

        # timeline slider
        ty = CANVAS_H + 20
        d.rectangle([8, ty, 8 + CANVAS_W, ty + 10], fill=PANEL)
        frac = controller.curr_ti / max(1, controller.T - 1)
        d.rectangle([8, ty, 8 + int(CANVAS_W * frac), ty + 10], fill=ACCENT)
        d.text((16 + CANVAS_W, ty), f"{controller.curr_ti} / {controller.T - 1}", fill=TEXT)

        # memory gauges
        g = controller.get_memory_gauges()
        gy = ty + 22
        for i, (name, val, mx) in enumerate((
                ("perm", g["permanent"], max(1, g["permanent"])),
                ("work", g["working"], max(1, g["working_max"])),
                ("LT", g["long_term"], max(1, g["long_term_max"])))):
            x0 = 8 + i * 170
            d.text((x0, gy), f"{name} {val}/{mx}", fill=TEXT)
            d.rectangle([x0 + 70, gy + 2, x0 + 160, gy + 12], fill=PANEL)
            d.rectangle([x0 + 70, gy + 2, x0 + 70 + int(90 * min(1.0, val / mx)), gy + 12],
                        fill=GAUGE)
        d.text((8 + 3 * 170, gy),
               f"object: {controller.curr_object}  vis: {controller.vis_mode}", fill=TEXT)

        # button row
        by = gy + 24
        x = 8
        for b in self.BUTTONS:
            w = 8 * len(b) + 14
            d.rectangle([x, by, x + w, by + 22], fill=PANEL, outline=ACCENT)
            d.text((x + 7, by + 5), b, fill=TEXT)
            x += w + 6
        d.text((8, by + 30), f"[{self.label}]", fill=ACCENT)

        self.frames.append((self.label, img))
        self.text_boxes.append(d.text_boxes)


def storyboard(frames: List[Tuple[str, np.ndarray]]):
    """The first refresh of each label, and the refresh before the last
    (the propagation's end) before the last pick, two columns, each panel
    under its label. -> (board image, panel count)."""
    picks, seen = [], set()
    for label, img in frames:
        if label not in seen:
            seen.add(label)
            picks.append((label, img))
    picks.insert(-1, ("propagation end", frames[-2][1]))
    cols = 2
    rows = -(-len(picks) // cols)
    board = _canvas((WIN_H + 18) * rows + 6, WIN_W * cols + 12, BOARD)
    d = Painter(board)
    for i, (label, img) in enumerate(picks):
        x = 4 + (i % cols) * (WIN_W + 4)
        y = 4 + (i // cols) * (WIN_H + 18)
        d.paste(img, (x, y + 14))
        d.text((x, y), label, fill=WHITE)
    return board, len(picks)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None,
                   help="the storyboard PNG (default: gui_session.png in the workspace)")
    p.add_argument("--workspace", default="workspace/gui_session",
                   help="a new or empty directory for the session's frames and saves")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--model", default="small", help="the model preset")
    p.add_argument("--weights", default=str(REPO / "tests/golden/state_dict_small.npz"))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the session; -> the storyboard's path, the refreshes and the
    panels."""
    from cutie_tpu_torch.config import Config, eval_config
    from cutie_tpu_torch.gui.main_controller import MainController
    from cutie_tpu_torch.ritm.utils import check_device
    from cutie_tpu_torch.utils.get_default_model import build_model
    from cutie_tpu_torch.utils.palette import davis_palette

    args = parse_args(argv)
    device = check_device(args.device)
    ws = Path(args.workspace)
    if ws.exists() and any(ws.iterdir()):
        raise FileExistsError(f"the workspace {ws} is not empty")
    rec = dict(np.load(REPO / "tests/golden/stream_small_work.npz"))
    img_dir = ws / "frames"
    os.makedirs(img_dir, exist_ok=True)
    for ti, f in enumerate(rec["frames"][:6]):
        write_png(str(img_dir / f"{ti:05d}.png"),
                  (np.transpose(f, (1, 2, 0)) * 255).astype(np.uint8))

    model_cfg = eval_config(args.model)
    model_cfg.merge({"mem_every": 3, "max_mem_frames": 3, "use_long_term": False})
    network = build_model(model_cfg, args.weights, device)
    cfg = Config({
        "images": str(img_dir), "video": None, "workspace": str(ws / "workspace"),
        "num_objects": 2, "buffer_size": 20, "save_queue_size": 20,
        "num_save_threads": 2, "max_overall_size": -1, "max_internal_size": -1,
        "mem_every": 3, "use_long_term": False, "output_fps": 10,
    })
    view = SoftwareView()
    ctl = MainController(cfg, bundle=(network, model_cfg), click_ckpt=None, device=device)
    ctl.view = view
    try:
        view.label = "open"
        view.text_to_console("session start")
        ctl.load_frame(0)

        # a click: a real RITM pass through the ClickController
        view.label = "click(+) at (30,20) on object 1"
        view.text_to_console("click +(30,20) obj1")
        ctl.click(30, 20)

        # the first mask imported (the reference's import-mask flow), so
        # that the propagation tracks
        mask_file = str(ws / "gt.png")
        write_png(mask_file, rec["mask0"].astype(np.uint8), palette=davis_palette)
        view.label = "import GT mask"
        view.text_to_console("import mask gt.png")
        ctl.import_mask(mask_file)

        view.label = "propagate forward"
        view.text_to_console("propagate forward ...")
        ctl.on_propagate("forward")

        view.label = "commit to permanent memory"
        view.text_to_console("commit -> permanent")
        ctl.on_commit()
    finally:
        ctl.close()

    board, panels = storyboard(view.frames)
    out = Path(args.out) if args.out else ws / "gui_session.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    write_png(str(out), board)
    print(f"wrote {out} ({len(view.frames)} refreshes, {panels} storyboard panels)")
    return {"out": str(out), "refreshes": len(view.frames), "panels": panels,
            "labels": [label for label, _ in view.frames]}


if __name__ == "__main__":
    main()
