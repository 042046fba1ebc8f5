"""tkinter widget layer for the interactive GUI (PySide6-free fallback):
the port's counterpart of cutie_tpu/gui/tk_widgets.py.

Behavioral parity target: reference gui/gui.py:18-485 — the same surface as
cutie_tpu_torch/gui/widgets.py (timeline slider + frame counter, object dial,
visualization-mode combo, propagate fwd/bwd/stop, commit, clear-memory
buttons, live memory-budget parameter boxes -> InferenceCore.update_config,
soft-mask toggle, fps/bitrate dials, memory gauges, console log handler,
minimap with viewport rectangle, zoom/pan canvas, import/export) — built on
the stdlib tkinter alone: frames are drawn into tk.PhotoImage from binary
PPM made in memory (utils/image_io.py:encode_ppm), scaled to the canvas by
nearest neighbour, where cutie_tpu goes through Pillow's ImageTk.

Implements the same MainController `view` protocol as the Qt layer
(refresh(controller) + text_to_console), contract-tested headlessly in
tests/test_torch_gui.py. Opening a window still requires an X display;
tk_display_available() reports whether one is reachable.
"""
from __future__ import annotations

import logging

import numpy as np

from cutie_tpu_torch.utils.image_io import encode_ppm, resize_nearest

try:
    import tkinter as tk
    from tkinter import filedialog, ttk
    HAS_TK = True
except ImportError as _e:  # pragma: no cover - stripped-down python
    HAS_TK = False
    _IMPORT_ERROR = _e


def tk_display_available() -> bool:
    """True iff a Tk window can actually open (needs an X display)."""
    if not HAS_TK:
        return False
    try:
        root = tk.Tk()
        root.destroy()
        return True
    except tk.TclError:
        return False


def require_tk():
    if not HAS_TK:
        raise RuntimeError(
            f"tkinter is required for the fallback GUI ({_IMPORT_ERROR}).")


def fit(rgb: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, 3] scaled by nearest neighbour to fit width x height, the
    aspect ratio kept."""
    h, w = rgb.shape[:2]
    scale = min(width / w, height / h)
    return resize_nearest(rgb, max(1, int(h * scale)), max(1, int(w * scale)))


def photo_image(rgb: np.ndarray) -> "tk.PhotoImage":
    return tk.PhotoImage(data=encode_ppm(rgb), format="PPM")


if HAS_TK:

    class ConsoleLogHandler(logging.Handler):
        """Routes Python logging into the GUI console box
        (reference gui/gui.py:355-356 text_to_console)."""

        def __init__(self, gui):
            super().__init__(level=logging.INFO)
            self.gui = gui

        def emit(self, record):
            try:
                self.gui.text_to_console(self.format(record))
            except tk.TclError:  # widget already destroyed
                pass

    class TkGUI:
        """Main window; acts as the MainController's `view`.

        Mirrors cutie_tpu_torch/gui/widgets.py:GUI widget-for-widget; see that
        module for the reference-line citations per control.
        """

        VIS_MODES = ("davis", "fade", "light", "popup", "layer", "rgba",
                     "mask", "image")

        def __init__(self, controller, cfg, root=None):
            require_tk()
            self.controller = controller
            controller.view = self
            self.root = root or tk.Tk()
            self.root.title("cutie_tpu_torch interactive demo")

            self.zoom = 1.0
            self.pan = [0.0, 0.0]
            self._panning = False
            self._last = None
            self._photo = None      # keep refs: Tk drops unreferenced images
            self._mini_photo = None

            main_row = ttk.Frame(self.root)
            main_row.pack(side=tk.TOP, fill=tk.BOTH, expand=True)
            self.canvas = tk.Canvas(main_row, width=854, height=480,
                                    background="black", highlightthickness=0)
            self.canvas.pack(side=tk.LEFT, fill=tk.BOTH, expand=True)
            right = ttk.Frame(main_row)
            right.pack(side=tk.RIGHT, fill=tk.Y)
            self.minimap = tk.Canvas(right, width=192, height=108,
                                     background="black", highlightthickness=0)
            self.minimap.pack(side=tk.TOP)
            self.console = tk.Text(right, height=8, width=40, state=tk.DISABLED)
            self.console.pack(side=tk.TOP, fill=tk.BOTH, expand=True)
            self._log_handler = ConsoleLogHandler(self)
            logging.getLogger("cutie_tpu_torch").addHandler(self._log_handler)

            # clicks: left = positive, right = negative, middle drag = pan,
            # wheel = zoom (same gestures as the Qt Canvas)
            self.canvas.bind("<Button-1>", lambda e: self._click(e, False))
            self.canvas.bind("<Button-3>", lambda e: self._click(e, True))
            self.canvas.bind("<Button-2>", self._pan_start)
            self.canvas.bind("<B2-Motion>", self._pan_move)
            self.canvas.bind("<ButtonRelease-2>", self._pan_end)
            self.canvas.bind("<MouseWheel>",
                             lambda e: self._wheel(e, e.delta > 0))
            self.canvas.bind("<Button-4>", lambda e: self._wheel(e, True))
            self.canvas.bind("<Button-5>", lambda e: self._wheel(e, False))

            timeline_row = ttk.Frame(self.root)
            timeline_row.pack(side=tk.TOP, fill=tk.X)
            self._timeline_var = tk.IntVar(value=0)
            self._timeline_guard = False
            self.timeline = ttk.Scale(
                timeline_row, from_=0, to=controller.T - 1,
                orient=tk.HORIZONTAL, command=self._timeline_moved)
            self.timeline.pack(side=tk.LEFT, fill=tk.X, expand=True)
            self.lcd = ttk.Label(timeline_row, text="0 / %d" % (controller.T - 1))
            self.lcd.pack(side=tk.RIGHT)

            controls = ttk.Frame(self.root)
            controls.pack(side=tk.TOP, fill=tk.X)
            ttk.Label(controls, text="Object:").pack(side=tk.LEFT)
            self._object_var = tk.IntVar(value=controller.curr_object)
            self.object_dial = tk.Spinbox(
                controls, from_=1, to=controller.num_objects, width=4,
                textvariable=self._object_var, command=self._set_object)
            self.object_dial.pack(side=tk.LEFT)
            ttk.Label(controls, text="Overlay:").pack(side=tk.LEFT)
            self._vis_var = tk.StringVar(value=controller.vis_mode)
            self.vis_combo = ttk.OptionMenu(
                controls, self._vis_var, controller.vis_mode, *self.VIS_MODES,
                command=lambda mode: controller.set_vis_mode(mode))
            self.vis_combo.pack(side=tk.LEFT)
            self._soft_var = tk.BooleanVar(value=controller.save_soft_mask)
            self.save_soft_mask_checkbox = ttk.Checkbutton(
                controls, text="Save soft masks", variable=self._soft_var,
                command=lambda: controller.on_save_soft_mask_toggle(
                    self._soft_var.get()))
            self.save_soft_mask_checkbox.pack(side=tk.LEFT)
            ttk.Label(controls, text="perm/work/LT:").pack(side=tk.LEFT)
            self.perm_gauge = ttk.Progressbar(controls, length=80)
            self.work_gauge = ttk.Progressbar(controls, length=80)
            self.lt_gauge = ttk.Progressbar(controls, length=80)
            for g in (self.perm_gauge, self.work_gauge, self.lt_gauge):
                g.pack(side=tk.LEFT, padx=2)

            # live memory-budget parameter boxes -> update_config
            params = ttk.Frame(self.root)
            params.pack(side=tk.TOP, fill=tk.X)
            lt = controller.processor.cfg.get("long_term")
            self.work_mem_min = self._parameter_box(
                params, "Min. working memory (frames)", 1, 100,
                lt.min_mem_frames if lt else 5, self._on_memory_param_change)
            self.work_mem_max = self._parameter_box(
                params, "Max. working memory (frames)", 2, 100,
                lt.max_mem_frames if lt
                else controller.processor.max_mem_frames + 1,
                self._on_work_max_change)
            self.long_mem_max = self._parameter_box(
                params, "Max. long-term memory (tokens)", 256, 10 ** 6,
                lt.max_num_tokens if lt else 10000,
                self._on_memory_param_change)
            self.mem_every_box = self._parameter_box(
                params, "Memory frame every (r)", 1, 100,
                controller.processor.mem_every, self._on_memory_param_change)
            self.fps_dial = self._parameter_box(
                params, "Output FPS", 1, 60, controller.output_fps,
                lambda: controller.on_fps_change(int(self.fps_dial.get())))
            self.bitrate_dial = self._parameter_box(
                params, "Output bitrate (Mbps)", 1, 100,
                controller.output_bitrate,
                lambda: controller.on_bitrate_change(
                    int(self.bitrate_dial.get())))

            buttons = ttk.Frame(self.root)
            buttons.pack(side=tk.TOP, fill=tk.X)
            for text, cb in (
                    ("Propagate forward",
                     lambda: controller.on_propagate("forward")),
                    ("Propagate backward",
                     lambda: controller.on_propagate("backward")),
                    ("Stop", controller.stop_propagation),
                    ("Commit to permanent memory", controller.on_commit),
                    ("Clear memory", controller.on_clear_memory),
                    ("Clear non-permanent memory",
                     controller.on_clear_non_permanent_memory),
                    ("Reset object", controller.on_reset_object),
                    ("Undo click", controller.undo_click),
                    ("Export video", lambda: controller.export_video()),
                    ("Import mask", self._import_mask),
                    ("Import layer", self._import_layer)):
                ttk.Button(buttons, text=text, command=cb).pack(side=tk.LEFT)

            self.root.protocol("WM_DELETE_WINDOW", self._on_close)
            self.refresh(controller)

        # ------------------------------------------------------------ wiring

        @staticmethod
        def _parameter_box(parent, label, minimum, maximum, value, callback):
            frame = ttk.Frame(parent)
            frame.pack(side=tk.LEFT, padx=4)
            ttk.Label(frame, text=label).pack(side=tk.LEFT)
            var = tk.IntVar(value=int(value))
            spin = tk.Spinbox(frame, from_=minimum, to=maximum, width=7,
                              textvariable=var, command=callback)
            spin.bind("<Return>", lambda e: callback())
            spin.bind("<FocusOut>", lambda e: callback())
            spin.pack(side=tk.LEFT)
            return spin

        def _set_object(self):
            self.controller.curr_object = int(self._object_var.get())

        def _timeline_moved(self, value):
            if self._timeline_guard:
                return
            self.controller.load_frame(int(float(value)))

        def _on_work_max_change(self):
            # max must stay > min (reference main_controller.py:525-530)
            mx = max(int(self.work_mem_max.get()),
                     int(self.work_mem_min.get()) + 1)
            self.work_mem_max.delete(0, tk.END)
            self.work_mem_max.insert(0, str(mx))
            self._on_memory_param_change()

        def _on_memory_param_change(self):
            updates = {"mem_every": int(self.mem_every_box.get())}
            if self.controller.processor.use_long_term:
                updates["long_term"] = {
                    "min_mem_frames": int(self.work_mem_min.get()),
                    "max_mem_frames": int(self.work_mem_max.get()),
                    "max_num_tokens": int(self.long_mem_max.get()),
                }
            else:
                updates["max_mem_frames"] = int(self.work_mem_max.get())
            self.controller.update_memory_config(**updates)

        def text_to_console(self, text: str):
            self.console.configure(state=tk.NORMAL)
            self.console.insert(tk.END, text + "\n")
            self.console.see(tk.END)
            self.console.configure(state=tk.DISABLED)

        # ----------------------------------------------------- canvas gestures

        def _canvas_size(self):
            return (max(1, self.canvas.winfo_width()),
                    max(1, self.canvas.winfo_height()))

        def widget_to_image(self, wx, wy):
            c = self.controller
            vw, vh = self._canvas_size()
            x = (self.pan[0] + (wx / vw) / self.zoom) * c.w
            y = (self.pan[1] + (wy / vh) / self.zoom) * c.h
            return (int(np.clip(x, 0, c.w - 1)), int(np.clip(y, 0, c.h - 1)))

        def _click(self, event, is_neg):
            x, y = self.widget_to_image(event.x, event.y)
            self.controller.click(x, y, is_neg=is_neg)

        def _pan_start(self, event):
            self._panning = True
            self._last = (event.x, event.y)

        def _pan_move(self, event):
            if not self._panning or self._last is None:
                return
            vw, vh = self._canvas_size()
            dx, dy = event.x - self._last[0], event.y - self._last[1]
            self._last = (event.x, event.y)
            self.pan[0] -= dx / vw / self.zoom
            self.pan[1] -= dy / vh / self.zoom
            self._clamp_pan()
            self.refresh(self.controller)

        def _pan_end(self, event):
            self._panning = False

        def _wheel(self, event, up):
            old = self.zoom
            self.zoom = float(np.clip(self.zoom * (1.25 if up else 0.8),
                                      1.0, 16.0))
            vw, vh = self._canvas_size()
            fx, fy = event.x / vw, event.y / vh
            self.pan[0] += fx / old - fx / self.zoom
            self.pan[1] += fy / old - fy / self.zoom
            self._clamp_pan()
            self.refresh(self.controller)

        def _clamp_pan(self):
            lim = 1.0 - 1.0 / self.zoom
            self.pan[0] = float(np.clip(self.pan[0], 0.0, lim))
            self.pan[1] = float(np.clip(self.pan[1], 0.0, lim))

        # ----------------------------------------------------------- refresh

        def refresh(self, controller):
            vis = np.ascontiguousarray(controller.visualize()[..., :3])
            h, w = vis.shape[:2]
            if self.zoom > 1.0:  # zoomed viewport crop
                px, py = self.pan
                x0, y0 = int(px * w), int(py * h)
                view = vis[y0:y0 + max(1, int(h / self.zoom)),
                           x0:x0 + max(1, int(w / self.zoom))]
            else:
                view = vis
            vw, vh = self._canvas_size()
            self._photo = photo_image(fit(view, vw, vh))
            self.canvas.delete("all")
            self.canvas.create_image(vw // 2, vh // 2, image=self._photo)

            # minimap: whole frame + viewport rectangle
            mw, mh = 192, 108
            mini = fit(vis, mw, mh)
            mini_h, mini_w = mini.shape[:2]
            self._mini_photo = photo_image(mini)
            self.minimap.delete("all")
            self.minimap.create_image(mw // 2, mh // 2, image=self._mini_photo)
            if self.zoom > 1.0:
                px, py = self.pan
                x0 = (mw - mini_w) // 2 + px * mini_w
                y0 = (mh - mini_h) // 2 + py * mini_h
                self.minimap.create_rectangle(
                    x0, y0, x0 + mini_w / self.zoom,
                    y0 + mini_h / self.zoom, outline="red", width=2)

            self._timeline_guard = True
            self.timeline.set(controller.curr_ti)
            self._timeline_guard = False
            self.lcd.configure(
                text="%d / %d" % (controller.curr_ti, controller.T - 1))
            g = controller.get_memory_gauges()
            self.work_gauge.configure(maximum=max(1, g["working_max"]),
                                      value=g["working"])
            self.lt_gauge.configure(maximum=max(1, g["long_term_max"]),
                                    value=g["long_term"])
            self.perm_gauge.configure(maximum=max(1, g["permanent"]),
                                      value=g["permanent"])
            self.root.update_idletasks()
            self.root.update()

        def _import_mask(self):
            fn = filedialog.askopenfilename(title="Import mask")
            if fn:
                self.controller.import_mask(fn)

        def _import_layer(self):
            fn = filedialog.askopenfilename(title="Import layer")
            if fn:
                self.controller.import_layer(fn)

        def _on_close(self):
            logging.getLogger("cutie_tpu_torch").removeHandler(self._log_handler)
            self.controller.close()
            self.root.destroy()

        def mainloop(self):
            self.root.mainloop()
