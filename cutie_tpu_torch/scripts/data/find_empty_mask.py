"""Index the frames whose masks are empty, to speed up training-time
sampling (the port's counterpart of scripts/data/find_empty_mask.py).

Writes {video: [frame names without extension, ...]} as JSON, every video
of the annotations directory listed (an empty list where no mask is
empty): the format of utils/subsets/*_empty_masks.txt.

  python -m cutie_tpu_torch.scripts.data.find_empty_mask annotations_dir out.json
"""
import json
import os
import sys
from os import path

from cutie_tpu_torch.utils.image_io import read_any


def process_vid(data_path: str, v: str):
    return [f[:-4] for f in sorted(os.listdir(path.join(data_path, v)))
            if read_any(path.join(data_path, v, f))[0].max() == 0]


def main(argv=None) -> None:
    data_path, output_path = sys.argv[1:3] if argv is None else argv[:2]
    output = {v: process_vid(data_path, v) for v in sorted(os.listdir(data_path))}
    with open(output_path, "w") as f:
        json.dump(output, f)


if __name__ == "__main__":
    main()
