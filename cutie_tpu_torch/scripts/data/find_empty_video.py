"""Print the videos whose FIRST mask is empty, which cannot seed training
samples (the port's counterpart of scripts/data/find_empty_video.py); a
video without masks is printed as "<video> (no masks)".

  python -m cutie_tpu_torch.scripts.data.find_empty_video annotations_dir
"""
import os
import sys
from os import path

from cutie_tpu_torch.utils.image_io import read_any


def main(argv=None) -> None:
    data_path = sys.argv[1] if argv is None else argv[0]
    for v in sorted(os.listdir(data_path)):
        frames = sorted(os.listdir(path.join(data_path, v)))
        if not frames:
            print(v, "(no masks)")
            continue
        if read_any(path.join(data_path, v, frames[0]))[0].max() == 0:
            print(v)


if __name__ == "__main__":
    main()
