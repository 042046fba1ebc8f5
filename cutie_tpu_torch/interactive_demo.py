"""Interactive GUI demo entry point on the card:

    python -m cutie_tpu_torch.interactive_demo --images DIR [--num_objects N]

The port's counterpart of the root interactive_demo.py (reference
interactive_demo.py:14-81): the same arguments and GUI config (amp,
long-term memory, mem_every 5, buffer and save-queue sizes), and --device
(default cuda; the CPU only when asked for). Prefers PySide6
(gui/widgets.py); falls back to a stdlib-tkinter window with the same
surface (gui/tk_widgets.py). --workspace_init_only builds the workspace
and exits. The headless MainController (all of the logic) needs neither.
"""
import argparse
import logging
import sys


def gui_config(args):
    """The GUI config (reference cutie/config/gui_config.yaml defaults)."""
    from cutie_tpu_torch.config import Config

    return Config({
        "images": args.images,
        "video": args.video,
        "workspace": args.workspace,
        "num_objects": args.num_objects,
        "weights": args.weights,
        "max_internal_size": args.max_internal_size,
        "max_overall_size": args.max_overall_size,
        "buffer_size": 20,
        "save_queue_size": 20,
        "num_save_threads": 4,
        "num_read_workers": 4,
        "use_long_term": True,
        "mem_every": 5,
        "output_fps": 24,
        # bf16 compute (reference gui_config.yaml:11 runs amp: True)
        "amp": True,
    })


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--images", default=None, help="directory of frames")
    parser.add_argument("--video", default=None, help="video file (needs cv2)")
    parser.add_argument("--workspace", default=None)
    parser.add_argument("--num_objects", type=int, default=1)
    parser.add_argument("--weights", default=None, help="CUTIE .pth/.npz weights")
    parser.add_argument("--ritm_weights", default=None,
                        help="RITM click-model .pth")
    parser.add_argument("--max_internal_size", type=int, default=480)
    parser.add_argument("--max_overall_size", type=int, default=1080)
    parser.add_argument("--workspace_init_only", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = gui_config(args)

    from cutie_tpu_torch.gui.main_controller import MainController

    controller = MainController(cfg, click_ckpt=args.ritm_weights,
                                device=args.device)
    if args.workspace_init_only:
        controller.close()
        return

    from cutie_tpu_torch.gui import widgets

    if widgets.has_qt():
        from PySide6.QtWidgets import QApplication

        app = QApplication(sys.argv)
        gui = widgets.GUI(controller, cfg)
        gui.show()
        code = app.exec()
        controller.close()
        sys.exit(code)

    # PySide6 unavailable: stdlib tkinter fallback with the same surface
    from cutie_tpu_torch.gui.tk_widgets import TkGUI, require_tk, tk_display_available

    require_tk()
    if not tk_display_available():
        controller.close()
        raise RuntimeError(
            "No GUI backend can open a window: PySide6 is not installed and "
            "tkinter found no X display ($DISPLAY unset / no X server). The "
            "headless MainController exposes every operation programmatically.")
    gui = TkGUI(controller, cfg)
    gui.mainloop()


if __name__ == "__main__":
    main()
