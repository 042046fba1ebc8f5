"""Convert BURST RLE-JSON annotations into DAVIS-format training data.

The port's counterpart of scripts/convert_burst_to_vos_train.py (reference
scripts/convert_burst_to_vos_train.py:35-79), without PIL: each annotated
frame's objects decoded from RLE into one DAVIS-palette PNG (utils/rle.py,
utils/palette.py, utils/image_io.py:write_png), the frame copied beside it
(copy2), sequences named '<dataset>_-_<seq>', optionally every frame
copied, one worker process a sequence.

  python -m cutie_tpu_torch.scripts.convert_burst_to_vos_train \
      --json_path train.json --frames_path BURST/frames/train \
      --output_path vos_train [--save_all_image] [--num_proc 16]
"""
import functools
import json
import multiprocessing
import os
from argparse import ArgumentParser
from os import path
from shutil import copy2

import numpy as np

from cutie_tpu_torch.utils import rle as rle_codec
from cutie_tpu_torch.utils.image_io import write_png
from cutie_tpu_torch.utils.palette import davis_palette


def process_video(sequence, frames_path: str, output_path: str,
                  save_all_image: bool) -> None:
    dataset = sequence["dataset"]
    seq_name = sequence["seq_name"]
    width, height = sequence["width"], sequence["height"]
    new_seq_name = f"{dataset}_-_{seq_name}"

    out_img = path.join(output_path, "JPEGImages", new_seq_name)
    out_mask = path.join(output_path, "Annotations", new_seq_name)
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_mask, exist_ok=True)

    for segmentation, image_path in zip(sequence["segmentations"],
                                        sequence["annotated_image_paths"]):
        output_mask = np.zeros((height, width), np.uint8)
        for object_id, obj in segmentation.items():
            mask = rle_codec.decode({"size": [height, width],
                                     "counts": obj["rle"]}).astype(bool)
            output_mask[mask] = int(object_id)
        write_png(path.join(out_mask, image_path[:-4] + ".png"), output_mask,
                  palette=davis_palette)
        copy2(path.join(frames_path, dataset, seq_name, image_path), out_img)

    if save_all_image:
        out_all = path.join(output_path, "JPEGImages_all_frames", new_seq_name)
        os.makedirs(out_all, exist_ok=True)
        for image_path in sequence["all_image_paths"]:
            copy2(path.join(frames_path, dataset, seq_name, image_path), out_all)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--json_path")
    parser.add_argument("--frames_path")
    parser.add_argument("--output_path")
    parser.add_argument("--save_all_image", action="store_true")
    parser.add_argument("--num_proc", type=int, default=16)
    args = parser.parse_args(argv)

    with open(args.json_path) as f:
        sequences = json.load(f)["sequences"]
    work = functools.partial(process_video, frames_path=args.frames_path,
                             output_path=args.output_path,
                             save_all_image=args.save_all_image)
    with multiprocessing.get_context("spawn").Pool(args.num_proc) as pool:
        list(pool.imap_unordered(work, sequences))


if __name__ == "__main__":
    main()
