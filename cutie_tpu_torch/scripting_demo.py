"""Canonical scripting-API usage (the port's counterpart of the root
scripting_demo.py; reference scripting_demo.py:12-67).

    python -m cutie_tpu_torch.scripting_demo [--images DIR --mask PNG]
        [--weights FILE] [--model base|small] [--output DIR] [--device cpu]

Feeds a directory of frames and a first-frame palette mask through
InferenceCore on the card (or the --device given) and writes the predicted
masks as palette PNGs. Without --images it makes a small synthetic video
(PNG frames) in a temporary directory.
"""
import argparse
import os
import tempfile
from os import path

import numpy as np


def make_synthetic_example(root: str, t: int = 8, h: int = 240, w: int = 320):
    """A square moving over a textured background: PNG frames in
    root/images and its first-frame DAVIS-palette mask root/masks/00000.png."""
    from cutie_tpu_torch.utils.image_io import write_png
    from cutie_tpu_torch.utils.palette import davis_palette

    os.makedirs(path.join(root, "images"), exist_ok=True)
    os.makedirs(path.join(root, "masks"), exist_ok=True)
    rng = np.random.default_rng(0)
    bg = rng.uniform(50, 130, size=(h, w, 3)).astype(np.uint8)
    sq = h // 4
    for ti in range(t):
        f = bg.copy()
        y, x = h // 8 + ti * 4, w // 8 + ti * 6
        f[y:y + sq, x:x + sq] = [220, 60, 40]
        write_png(path.join(root, "images", f"{ti:05d}.png"), f)
        if ti == 0:
            m = np.zeros((h, w), np.uint8)
            m[y:y + sq, x:x + sq] = 1
            write_png(path.join(root, "masks", "00000.png"), m, davis_palette)
    return path.join(root, "images"), path.join(root, "masks", "00000.png")


def run(images: str, mask_path: str, output: str, weights, model: str,
        device: str):
    from cutie_tpu_torch.config import eval_config, get_dataset_cfg
    from cutie_tpu_torch.inference import InferenceCore
    from cutie_tpu_torch.utils.get_default_model import build_model
    from cutie_tpu_torch.utils.image_io import read_image, read_png, write_png

    cfg = eval_config(model)
    get_dataset_cfg(cfg)
    processor = InferenceCore(build_model(cfg, weights, device), cfg)

    mask, _, palette = read_png(mask_path)
    objects = np.unique(mask)
    objects = objects[objects != 0].tolist()

    frames = sorted(os.listdir(images))
    os.makedirs(output, exist_ok=True)
    for ti, frame_name in enumerate(frames):
        image = read_image(path.join(images, frame_name))
        image_np = np.transpose(image.astype(np.float32) / 255.0, (2, 0, 1))

        if ti == 0:
            # first frame: provide the ground-truth mask to start tracking
            output_prob = processor.step(image_np, mask, objects=objects)
        else:
            output_prob = processor.step(image_np)

        out_mask = processor.output_prob_to_mask(output_prob).astype(np.uint8)
        write_png(path.join(output, frame_name.rsplit(".", 1)[0] + ".png"),
                  out_mask, palette)
        present = np.unique(out_mask)
        print(f"{frame_name}: objects present {present[present != 0].tolist()}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--images", default=None, help="directory of frames")
    parser.add_argument("--mask", default=None, help="first-frame palette png")
    parser.add_argument("--output", default="./output/demo")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--model", default="base", choices=["base", "small"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.images is not None:
        run(args.images, args.mask, args.output, args.weights, args.model,
            args.device)
        return
    with tempfile.TemporaryDirectory() as tmp:
        images, mask = make_synthetic_example(tmp)
        run(images, mask, args.output, args.weights, args.model, args.device)


if __name__ == "__main__":
    main()
