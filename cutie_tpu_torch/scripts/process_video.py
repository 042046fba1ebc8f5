"""Single-video processing CLI (the port's counterpart of
scripts/process_video.py; reference scripts/process_video.py:22-284).

Reads a video (mp4 through cv2, or a directory of frames) and one or more
mask PNGs named after their frames, commits every given mask to permanent
memory (force_permanent=True), then propagates through the whole video and
writes palette masks, and with --output_video an overlay mp4 (cv2). Runs on
the card unless --device says otherwise.

  python -m cutie_tpu_torch.scripts.process_video --video in.mp4 --masks mask_dir --output out
  python -m cutie_tpu_torch.scripts.process_video --images frame_dir --masks mask_dir --output out
"""
import argparse
import os
from os import path

import numpy as np


def read_frames(args):
    if args.video:
        import cv2
        cap = cv2.VideoCapture(args.video)
        names = []
        frames = []
        ti = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            names.append(f"{ti:07d}.jpg")
            ti += 1
        cap.release()
        fps = cap.get(5) or 24
        return names, frames, fps
    from cutie_tpu_torch.utils.image_io import read_image

    names = sorted(os.listdir(args.images))
    frames = [read_image(path.join(args.images, n)) for n in names]
    return names, frames, 24


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--video", default=None)
    parser.add_argument("--images", default=None)
    parser.add_argument("--masks", required=True,
                        help="directory of palette mask PNGs named after frames")
    parser.add_argument("--output", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--model", default="base", choices=["base", "small"])
    parser.add_argument("--max_internal_size", type=int, default=480)
    parser.add_argument("--mem_every", type=int, default=5)
    parser.add_argument("--output_video", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if (args.video is None) == (args.images is None):
        parser.error("provide exactly one of --video / --images")

    from cutie_tpu_torch.config import eval_config, get_dataset_cfg
    from cutie_tpu_torch.inference import InferenceCore
    from cutie_tpu_torch.utils.get_default_model import build_model
    from cutie_tpu_torch.utils.image_io import read_png, write_png
    from cutie_tpu_torch.utils.palette import davis_palette

    cfg = eval_config(args.model)
    cfg.dataset = "generic"
    get_dataset_cfg(cfg)
    cfg.max_internal_size = args.max_internal_size
    cfg.mem_every = args.mem_every

    processor = InferenceCore(build_model(cfg, args.weights, args.device), cfg)

    names, frames, fps = read_frames(args)
    mask_files = {path.splitext(f)[0]: path.join(args.masks, f)
                  for f in os.listdir(args.masks)}

    # pass 1: commit every provided mask to permanent memory
    # (reference process_video.py:115-118)
    palette = davis_palette
    for ti, name in enumerate(names):
        stem = path.splitext(name)[0]
        if stem in mask_files:
            mask, _, mask_palette = read_png(mask_files[stem])
            if mask_palette is not None:
                palette = bytes(mask_palette)
            objects = np.unique(mask)
            objects = objects[objects != 0].tolist()
            image_np = np.transpose(frames[ti].astype(np.float32) / 255.0, (2, 0, 1))
            processor.step(image_np, mask, objects=objects, force_permanent=True)

    # pass 2: propagate through the whole video
    os.makedirs(args.output, exist_ok=True)
    out_frames = []
    for ti, name in enumerate(names):
        image_np = np.transpose(frames[ti].astype(np.float32) / 255.0, (2, 0, 1))
        prob = processor.step(image_np, end=(ti == len(names) - 1))
        out_mask = processor.output_prob_to_mask(prob).astype(np.uint8)
        write_png(path.join(args.output, path.splitext(name)[0] + ".png"),
                  out_mask, palette)
        if args.output_video:
            colors = np.frombuffer(palette, np.uint8).reshape(-1, 3)
            overlay = colors[np.clip(out_mask, 0, len(colors) - 1)]
            alpha = ((out_mask == 0) * 0.5 + 0.5)[..., None]
            out_frames.append((frames[ti] * alpha + overlay * (1 - alpha))
                              .astype(np.uint8))
        print(f"{name} done")

    if args.output_video:
        import cv2
        h, w = out_frames[0].shape[:2]
        vw = cv2.VideoWriter(path.join(args.output, "visualization.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in out_frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()


if __name__ == "__main__":
    main()
