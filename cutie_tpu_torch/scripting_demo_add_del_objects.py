"""Mid-video object addition and deletion (the port's counterpart of the
root scripting_demo_add_del_objects.py; reference
scripting_demo_add_del_objects.py:28-73).

    python -m cutie_tpu_torch.scripting_demo_add_del_objects
        [--weights FILE] [--model base|small] [--output DIR] [--device cpu]

On a synthetic two-object video, on the card (or the --device given): object
1 from its mask at t=0; object 2 added at t=4 (its mask merges with the
propagated prediction of object 1); object 1 deleted at t=10 with
processor.delete_objects([1]). Writes a palette PNG a frame and prints the
objects present.
"""
import argparse
import os
from os import path

import numpy as np


def make_two_object_video(t: int = 14, h: int = 240, w: int = 320):
    rng = np.random.default_rng(1)
    bg = rng.uniform(40, 120, size=(h, w, 3)).astype(np.uint8)
    sq = h // 5
    frames, masks = [], {}
    for ti in range(t):
        f = bg.copy()
        y1, x1 = h // 8 + ti * 3, w // 8 + ti * 4
        y2, x2 = h // 2, w // 2 + ti * 2
        f[y1:y1 + sq, x1:x1 + sq] = [220, 60, 40]
        f[y2:y2 + sq, x2:x2 + sq] = [40, 80, 220]
        frames.append(f)
        if ti == 0:
            m = np.zeros((h, w), np.uint8)
            m[y1:y1 + sq, x1:x1 + sq] = 1
            masks[0] = m
        if ti == 4:
            m = np.zeros((h, w), np.uint8)
            m[y2:y2 + sq, x2:x2 + sq] = 2
            masks[4] = m
    return frames, masks


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", default="./output/demo_add_del")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--model", default="small", choices=["base", "small"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cutie_tpu_torch.config import eval_config, get_dataset_cfg
    from cutie_tpu_torch.inference import InferenceCore
    from cutie_tpu_torch.utils.get_default_model import build_model
    from cutie_tpu_torch.utils.image_io import write_png
    from cutie_tpu_torch.utils.palette import davis_palette

    cfg = eval_config(args.model)
    get_dataset_cfg(cfg)
    processor = InferenceCore(build_model(cfg, args.weights, args.device), cfg)

    frames, masks = make_two_object_video()
    os.makedirs(args.output, exist_ok=True)

    for ti, frame in enumerate(frames):
        image_np = np.transpose(frame.astype(np.float32) / 255.0, (2, 0, 1))

        if ti == 10:
            processor.delete_objects([1])

        if ti in masks:
            # mask may be partial: present objects keep their propagated
            # prediction, listed objects are overwritten by the mask
            m = masks[ti]
            objects = np.unique(m)
            objects = objects[objects != 0].tolist()
            output_prob = processor.step(image_np, m, objects=objects)
        else:
            output_prob = processor.step(image_np)

        out_mask = processor.output_prob_to_mask(output_prob).astype(np.uint8)
        write_png(path.join(args.output, f"{ti:05d}.png"), out_mask,
                  davis_palette)
        present = np.unique(out_mask)
        print(f"t={ti}: objects {present[present != 0].tolist()}")


if __name__ == "__main__":
    main()
