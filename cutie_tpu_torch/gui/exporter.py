"""Video / binary-mask export: the port's counterpart of
cutie_tpu/gui/exporter.py.

Behavioral parity target: reference gui/exporter.py:10-57 (PyAV h264 mp4 of
saved visualizations + binary mask export). The writer is chosen as
cutie_tpu chooses it: PyAV's h264 with the bitrate dial applied when `av`
imports, else cv2.VideoWriter (mp4v, no bitrate dial); both are imported
when a video is written, and with neither installed that raises an
ImportError naming both. Frames are read, and binary masks written,
through utils/image_io.py.
"""
from __future__ import annotations

import logging
import os
from os import path

import numpy as np

from cutie_tpu_torch.utils.image_io import read_image, read_png, write_png

log = logging.getLogger(__name__)


def _list_frames(input_dir: str):
    frames = sorted(os.listdir(input_dir))
    return [f for f in frames if f.lower().endswith((".jpg", ".png"))]


def _video_writer():
    """('av', module) or ('cv2', module): PyAV first, as cutie_tpu."""
    try:
        import av
        return "av", av
    except ImportError:
        pass
    try:
        import cv2
        return "cv2", cv2
    except ImportError as e:
        raise ImportError(
            "writing a video needs PyAV (the av package) or cv2 "
            "(opencv-python), and neither is installed") from e


def _convert_frames_to_video_av(av, input_dir: str, frames, output_path: str,
                                fps: int, bitrate_mbps: int,
                                progress_callback=None) -> bool:
    """PyAV h264 path (reference gui/exporter.py:10-36): yuv420p stream with
    the Mbps dial applied as the encoder bit_rate."""
    first = read_image(path.join(input_dir, frames[0]))
    h, w = first.shape[:2]
    with av.open(output_path, mode="w") as container:
        stream = container.add_stream("h264", rate=int(fps))
        # even dims required by yuv420p
        stream.width = w - (w % 2)
        stream.height = h - (h % 2)
        stream.pix_fmt = "yuv420p"
        stream.bit_rate = int(bitrate_mbps * 1e6)
        for i, name in enumerate(frames):
            arr = read_image(path.join(input_dir, name))[:stream.height, :stream.width]
            frame = av.VideoFrame.from_ndarray(np.ascontiguousarray(arr), format="rgb24")
            for packet in stream.encode(frame):
                container.mux(packet)
            if progress_callback is not None and i % 10 == 0:
                progress_callback(i / len(frames))
        for packet in stream.encode():  # flush
            container.mux(packet)
    log.info("Wrote %s (%d frames, h264 @ %d Mbps)", output_path, len(frames),
             bitrate_mbps)
    return True


def convert_frames_to_video(input_dir: str, output_path: str, fps: int = 24,
                            bitrate_mbps: int = 1,
                            progress_callback=None) -> bool:
    """bitrate_mbps mirrors the reference PyAV exporter's Mbps dial
    (gui/exporter.py:10-36). Applied for real when PyAV is available;
    cv2.VideoWriter has no bitrate control, so there it is accepted for API
    parity and recorded in the log line."""
    kind, lib = _video_writer()
    frames = _list_frames(input_dir)
    if not frames:
        log.warning("No frames in %s", input_dir)
        return False
    os.makedirs(path.dirname(output_path) or ".", exist_ok=True)
    if kind == "av":
        return _convert_frames_to_video_av(lib, input_dir, frames, output_path,
                                           fps, bitrate_mbps, progress_callback)
    first = read_image(path.join(input_dir, frames[0]))
    h, w = first.shape[:2]
    writer = lib.VideoWriter(output_path, lib.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for i, name in enumerate(frames):
            rgb = read_image(path.join(input_dir, name))
            writer.write(np.ascontiguousarray(rgb[..., ::-1]))
            if progress_callback is not None and i % 10 == 0:
                progress_callback(i / len(frames))
    finally:
        writer.release()
    log.info("Wrote %s (%d frames; cv2, bitrate dial %d Mbps not applied)",
             output_path, len(frames), bitrate_mbps)
    return True


def convert_mask_to_binary(mask_dir: str, output_dir: str, target_objects,
                           progress_callback=None) -> bool:
    """Export per-frame binary masks of the selected objects
    (exporter.py binary path): 255 where a target object is, else 0, as
    8-bit grayscale PNGs."""
    os.makedirs(output_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(mask_dir) if f.endswith(".png"))
    for i, name in enumerate(names):
        mask = read_png(path.join(mask_dir, name))[0]
        binary = np.isin(mask, list(target_objects)).astype(np.uint8) * 255
        write_png(path.join(output_dir, name), binary)
        if progress_callback is not None and i % 10 == 0:
            progress_callback(i / len(names))
    return True
