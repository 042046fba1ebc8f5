"""PySide6 widget layer for the interactive GUI: the port's counterpart of
cutie_tpu/gui/widgets.py.

Behavioral parity target: reference gui/gui.py:18-485 — timeline slider + LCD
frame counter, object dial, visualization-mode combo, propagate fwd/bwd,
commit, memory gauges AND live memory-budget parameter boxes (work min/max,
long-term max tokens, mem_every -> InferenceCore.update_config, reference
gui/main_controller.py:525-541), soft-mask save toggle
(gui/main_controller.py:606-607), fps/bitrate dials, console with a Python
logging handler (gui/gui.py:188-191,355-356), minimap preview, zoom/pan
canvas, import/export buttons.

PySide6 is imported when GUI, Canvas or ConsoleLogHandler is first asked
of this module (require_qt raises a RuntimeError naming PySide6 when it is
missing), so that the module imports without it; everything except the
window works headless. The MainController `view` protocol (refresh(controller)
+ the controller attributes/methods referenced here) is contract-tested
without Qt in tests/test_torch_gui.py.
"""
from __future__ import annotations

import logging

import numpy as np

_QT_NAMES = ("ConsoleLogHandler", "Canvas", "GUI")


def has_qt() -> bool:
    """True iff PySide6 imports."""
    try:
        require_qt()
    except RuntimeError:
        return False
    return True


def require_qt():
    try:
        import PySide6  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "PySide6 is required for the interactive GUI but is not installed "
            f"in this environment ({e}). The headless controller "
            "(cutie_tpu_torch.gui.main_controller.MainController) exposes the "
            "same operations programmatically.") from e


def __getattr__(name):
    """The Qt classes, defined at first use (PEP 562)."""
    if name in _QT_NAMES:
        globals().update(_define_qt_classes())
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _define_qt_classes():
    require_qt()
    from PySide6.QtCore import Qt
    from PySide6.QtGui import QImage, QPainter, QPen, QPixmap
    from PySide6.QtWidgets import (QApplication, QCheckBox, QComboBox,
                                   QFileDialog, QHBoxLayout, QLabel,
                                   QMainWindow, QPlainTextEdit, QProgressBar,
                                   QPushButton, QSlider, QSpinBox,
                                   QVBoxLayout, QWidget)

    class ConsoleLogHandler(logging.Handler):
        """Routes Python logging into the GUI console box
        (reference gui/gui.py:355-356 text_to_console)."""

        def __init__(self, gui):
            super().__init__(level=logging.INFO)
            self.gui = gui

        def emit(self, record):
            try:
                self.gui.text_to_console(self.format(record))
            except RuntimeError:  # widget already destroyed
                pass

    class Canvas(QLabel):
        """Zoomable/pannable image canvas; forwards clicks in image coords."""

        def __init__(self, gui):
            super().__init__()
            self.gui = gui
            self.zoom = 1.0
            self.pan = [0.0, 0.0]  # fraction of image, top-left of viewport
            self.setMouseTracking(True)
            self._panning = False
            self._last = None

        # widget pixel -> image pixel under current zoom/pan
        def widget_to_image(self, wx, wy):
            c = self.gui.controller
            vw = max(1, self.width())
            vh = max(1, self.height())
            x = (self.pan[0] + (wx / vw) / self.zoom) * c.w
            y = (self.pan[1] + (wy / vh) / self.zoom) * c.h
            return int(np.clip(x, 0, c.w - 1)), int(np.clip(y, 0, c.h - 1))

        def wheelEvent(self, event):
            old = self.zoom
            self.zoom = float(np.clip(
                self.zoom * (1.25 if event.angleDelta().y() > 0 else 0.8),
                1.0, 16.0))
            # keep the cursor-anchored point fixed
            pos = event.position()
            fx, fy = pos.x() / max(1, self.width()), pos.y() / max(1, self.height())
            self.pan[0] += fx / old - fx / self.zoom
            self.pan[1] += fy / old - fy / self.zoom
            self._clamp_pan()
            self.gui.refresh(self.gui.controller)

        def _clamp_pan(self):
            lim = 1.0 - 1.0 / self.zoom
            self.pan[0] = float(np.clip(self.pan[0], 0.0, lim))
            self.pan[1] = float(np.clip(self.pan[1], 0.0, lim))

        def mousePressEvent(self, event):
            if event.button() == Qt.MiddleButton:
                self._panning = True
                self._last = event.position()
                return
            x, y = self.widget_to_image(event.position().x(), event.position().y())
            self.gui.controller.click(x, y,
                                      is_neg=event.button() == Qt.RightButton)

        def mouseMoveEvent(self, event):
            if self._panning and self._last is not None:
                d = event.position() - self._last
                self._last = event.position()
                self.pan[0] -= d.x() / max(1, self.width()) / self.zoom
                self.pan[1] -= d.y() / max(1, self.height()) / self.zoom
                self._clamp_pan()
                self.gui.refresh(self.gui.controller)

        def mouseReleaseEvent(self, event):
            if event.button() == Qt.MiddleButton:
                self._panning = False

    def _np_to_qimage(vis: np.ndarray) -> "QImage":
        vis = np.ascontiguousarray(vis)
        fmt = (QImage.Format_RGBA8888 if vis.shape[-1] == 4
               else QImage.Format_RGB888)
        return QImage(vis.data, vis.shape[1], vis.shape[0], vis.strides[0],
                      fmt).copy()

    def _parameter_box(label, minimum, maximum, value, callback):
        spin = QSpinBox()
        spin.setRange(minimum, maximum)
        spin.setValue(value)
        spin.editingFinished.connect(callback)
        row = QHBoxLayout()
        row.addWidget(QLabel(label))
        row.addWidget(spin)
        return spin, row

    class GUI(QMainWindow):
        """Main window; acts as the MainController's `view`."""

        def __init__(self, controller, cfg):
            super().__init__()
            self.controller = controller
            controller.view = self
            self.setWindowTitle("cutie_tpu_torch interactive demo")

            self.canvas = Canvas(self)
            self.minimap = QLabel()
            self.minimap.setFixedSize(192, 108)

            self.timeline = QSlider(Qt.Horizontal)
            self.timeline.setMaximum(controller.T - 1)
            self.timeline.valueChanged.connect(
                lambda v: controller.load_frame(v))
            self.lcd = QLabel("0 / %d" % (controller.T - 1))

            # object dial (reference gui/gui.py:76-81)
            self.object_dial = QSpinBox()
            self.object_dial.setRange(1, controller.num_objects)
            self.object_dial.valueChanged.connect(self._set_object)

            self.vis_combo = QComboBox()
            for mode in ("davis", "fade", "light", "popup", "layer", "rgba",
                         "mask", "image"):
                self.vis_combo.addItem(mode)
            self.vis_combo.currentTextChanged.connect(controller.set_vis_mode)

            fwd = QPushButton("Propagate forward")
            fwd.clicked.connect(lambda: controller.on_propagate("forward"))
            bwd = QPushButton("Propagate backward")
            bwd.clicked.connect(lambda: controller.on_propagate("backward"))
            stop = QPushButton("Stop")
            stop.clicked.connect(controller.stop_propagation)
            commit = QPushButton("Commit to permanent memory")
            commit.clicked.connect(controller.on_commit)
            clear_mem = QPushButton("Clear memory")
            clear_mem.clicked.connect(controller.on_clear_memory)
            clear_np = QPushButton("Clear non-permanent memory")
            clear_np.clicked.connect(controller.on_clear_non_permanent_memory)
            reset_obj = QPushButton("Reset object")
            reset_obj.clicked.connect(controller.on_reset_object)
            undo = QPushButton("Undo click")
            undo.clicked.connect(controller.undo_click)
            export = QPushButton("Export video")
            export.clicked.connect(lambda: controller.export_video())
            import_mask = QPushButton("Import mask")
            import_mask.clicked.connect(self._import_mask)
            import_layer = QPushButton("Import layer")
            import_layer.clicked.connect(self._import_layer)

            # live memory-budget parameter boxes -> update_config
            # (reference gui/gui.py:160-179 + main_controller.py:525-541)
            lt = controller.processor.cfg.get("long_term")
            self.work_mem_min, work_min_row = _parameter_box(
                "Min. working memory (frames)", 1, 100,
                lt.min_mem_frames if lt else 5, self._on_memory_param_change)
            self.work_mem_max, work_max_row = _parameter_box(
                "Max. working memory (frames)", 2, 100,
                lt.max_mem_frames if lt
                else controller.processor.max_mem_frames + 1,
                self._on_work_max_change)
            self.long_mem_max, long_max_row = _parameter_box(
                "Max. long-term memory (tokens)", 256, 10 ** 6,
                lt.max_num_tokens if lt else 10000,
                self._on_memory_param_change)
            self.mem_every_box, mem_every_row = _parameter_box(
                "Memory frame every (r)", 1, 100, controller.processor.mem_every,
                self._on_memory_param_change)

            self.save_soft_mask_checkbox = QCheckBox("Save soft masks")
            self.save_soft_mask_checkbox.setChecked(controller.save_soft_mask)
            self.save_soft_mask_checkbox.toggled.connect(
                controller.on_save_soft_mask_toggle)

            self.fps_dial, fps_row = _parameter_box(
                "Output FPS", 1, 60, controller.output_fps,
                lambda: controller.on_fps_change(self.fps_dial.value()))
            self.bitrate_dial, bitrate_row = _parameter_box(
                "Output bitrate (Mbps)", 1, 100, controller.output_bitrate,
                lambda: controller.on_bitrate_change(self.bitrate_dial.value()))

            self.perm_gauge = QProgressBar()
            self.work_gauge = QProgressBar()
            self.lt_gauge = QProgressBar()
            self.console = QPlainTextEdit()
            self.console.setReadOnly(True)
            self.console.setMaximumHeight(100)
            self._log_handler = ConsoleLogHandler(self)
            logging.getLogger("cutie_tpu_torch").addHandler(self._log_handler)

            buttons = QHBoxLayout()
            for b in (fwd, bwd, stop, commit, clear_mem, clear_np, reset_obj,
                      undo, export, import_mask, import_layer):
                buttons.addWidget(b)
            controls = QHBoxLayout()
            controls.addWidget(QLabel("Object:"))
            controls.addWidget(self.object_dial)
            controls.addWidget(QLabel("Overlay:"))
            controls.addWidget(self.vis_combo)
            controls.addWidget(self.save_soft_mask_checkbox)
            controls.addWidget(QLabel("perm/work/LT:"))
            controls.addWidget(self.perm_gauge)
            controls.addWidget(self.work_gauge)
            controls.addWidget(self.lt_gauge)

            params = QHBoxLayout()
            for row in (work_min_row, work_max_row, long_max_row,
                        mem_every_row, fps_row, bitrate_row):
                params.addLayout(row)

            timeline_row = QHBoxLayout()
            timeline_row.addWidget(self.timeline, stretch=1)
            timeline_row.addWidget(self.lcd)

            right = QVBoxLayout()
            right.addWidget(self.minimap)
            right.addWidget(self.console, stretch=1)
            main_row = QHBoxLayout()
            main_row.addWidget(self.canvas, stretch=1)
            main_row.addLayout(right)

            layout = QVBoxLayout()
            layout.addLayout(main_row, stretch=1)
            layout.addLayout(timeline_row)
            layout.addLayout(controls)
            layout.addLayout(params)
            layout.addLayout(buttons)
            central = QWidget()
            central.setLayout(layout)
            self.setCentralWidget(central)
            self.refresh(controller)

        # ------------------------------------------------------------ wiring

        def _set_object(self, v):
            self.controller.curr_object = int(v)

        def _on_work_max_change(self):
            # max must stay > min (reference main_controller.py:525-530)
            self.work_mem_max.setValue(max(self.work_mem_max.value(),
                                           self.work_mem_min.value() + 1))
            self._on_memory_param_change()

        def _on_memory_param_change(self):
            updates = {"mem_every": self.mem_every_box.value()}
            if self.controller.processor.use_long_term:
                updates["long_term"] = {
                    "min_mem_frames": self.work_mem_min.value(),
                    "max_mem_frames": self.work_mem_max.value(),
                    "max_num_tokens": self.long_mem_max.value(),
                }
            else:
                updates["max_mem_frames"] = self.work_mem_max.value()
            self.controller.update_memory_config(**updates)

        def text_to_console(self, text: str):
            self.console.appendPlainText(text)

        # ----------------------------------------------------------- refresh

        def refresh(self, controller):
            vis = controller.visualize()
            qimg = _np_to_qimage(vis)
            pix = QPixmap.fromImage(qimg)
            # zoomed viewport crop
            z = self.canvas.zoom
            px, py = self.canvas.pan
            if z > 1.0:
                w, h = pix.width(), pix.height()
                pix_crop = pix.copy(int(px * w), int(py * h),
                                    max(1, int(w / z)), max(1, int(h / z)))
            else:
                pix_crop = pix
            self.canvas.setPixmap(pix_crop.scaled(
                self.canvas.size(), Qt.KeepAspectRatio))

            # minimap: whole frame + viewport rectangle
            mini = pix.scaled(self.minimap.size(), Qt.KeepAspectRatio)
            if z > 1.0:
                painter = QPainter(mini)
                painter.setPen(QPen(Qt.red, 2))
                painter.drawRect(int(px * mini.width()), int(py * mini.height()),
                                 int(mini.width() / z), int(mini.height() / z))
                painter.end()
            self.minimap.setPixmap(mini)

            self.timeline.blockSignals(True)
            self.timeline.setValue(controller.curr_ti)
            self.timeline.blockSignals(False)
            self.lcd.setText("%d / %d" % (controller.curr_ti, controller.T - 1))
            g = controller.get_memory_gauges()
            self.work_gauge.setMaximum(max(1, g["working_max"]))
            self.work_gauge.setValue(g["working"])
            self.lt_gauge.setMaximum(max(1, g["long_term_max"]))
            self.lt_gauge.setValue(g["long_term"])
            self.perm_gauge.setMaximum(max(1, g["permanent"]))
            self.perm_gauge.setValue(g["permanent"])
            QApplication.processEvents()

        def _import_mask(self):
            fn, _ = QFileDialog.getOpenFileName(self, "Import mask")
            if fn:
                self.controller.import_mask(fn)

        def _import_layer(self):
            fn, _ = QFileDialog.getOpenFileName(self, "Import layer")
            if fn:
                self.controller.import_layer(fn)

        def closeEvent(self, event):
            logging.getLogger("cutie_tpu_torch").removeHandler(self._log_handler)
            self.controller.close()
            super().closeEvent(event)

    return {"ConsoleLogHandler": ConsoleLogHandler, "Canvas": Canvas, "GUI": GUI}
