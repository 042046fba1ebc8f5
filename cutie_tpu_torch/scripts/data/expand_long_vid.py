"""Ping-pong extend every video of a DAVIS-style root N times, for
long-video stress testing (the port's counterpart of
scripts/data/expand_long_vid.py).

Frame k of the output is a copy of the input frame the ping-pong walk
reaches at step k (0, 1, ..., n-1, n-2, ..., 0, 1, ...), renamed
00000.jpg, 00001.jpg, ...; its mask, where the input has one, is copied to
00000.png, ...

  python -m cutie_tpu_torch.scripts.data.expand_long_vid in_root out_root multiplier
"""
import os
import sys
from os import path
from shutil import copy2


def expand(input_path: str, output_path: str, multiplier: int) -> None:
    image_path = path.join(input_path, "JPEGImages")
    gt_path = path.join(input_path, "Annotations")
    for vid in sorted(os.listdir(image_path)):
        os.makedirs(path.join(output_path, "JPEGImages", vid), exist_ok=True)
        os.makedirs(path.join(output_path, "Annotations", vid), exist_ok=True)
        frames = sorted(os.listdir(path.join(image_path, vid)))
        counter, output_counter, direction = 0, 0, 1
        for _ in range(multiplier * len(frames)):
            copy2(path.join(image_path, vid, frames[counter]),
                  path.join(output_path, "JPEGImages", vid, f"{output_counter:05d}.jpg"))
            mask_file = path.join(gt_path, vid, frames[counter].replace(".jpg", ".png"))
            if path.exists(mask_file):
                copy2(mask_file, path.join(output_path, "Annotations", vid,
                                           f"{output_counter:05d}.png"))
            counter += direction
            output_counter += 1
            if counter == 0 or counter == len(frames) - 1:
                direction *= -1


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    expand(argv[0], argv[1], int(argv[2]))


if __name__ == "__main__":
    main()
