"""Convert predicted PNG masks to a BURST-format RLE JSON (the port's
counterpart of scripts/mask_to_burst_json.py; same CLI as the reference's:
gt_json input_mask_dir output_json).

  python -m cutie_tpu_torch.scripts.mask_to_burst_json gt.json mask_dir out.json
"""
import json
import os
import sys
from collections import defaultdict
from os import path

import numpy as np

from cutie_tpu_torch.utils import rle as rle_codec
from cutie_tpu_torch.utils.image_io import read_png


def main(argv=None):
    gt_json_path, input_mask_path, output_json_path = (
        sys.argv[1:4] if argv is None else argv)
    with open(gt_json_path) as f:
        json_dict = json.load(f)

    videos = defaultdict(list)
    for video_name in os.listdir(input_mask_path):
        dataset, video = video_name.split("_-_")
        videos[dataset].append(video)

    for seq in json_dict["sequences"]:
        dataset, seq_name = seq["dataset"], seq["seq_name"]
        if not (dataset in videos and seq_name in videos[dataset]):
            raise ValueError(f"no masks for {dataset}/{seq_name}")
        segmentations = []
        for image_path in seq["annotated_image_paths"]:
            this_segment = {}
            mask_path = path.join(input_mask_path, f"{dataset}_-_{seq_name}",
                                  image_path[:-4] + ".png")
            if path.exists(mask_path):
                mask = read_png(mask_path)[0]
                labels = np.unique(mask)
                for label in labels[labels != 0].tolist():
                    this_mask = (mask == label).astype(np.uint8)
                    if this_mask.sum() == 0:
                        continue
                    enc = rle_codec.encode(this_mask)
                    this_segment[label] = {"rle": enc["counts"]}
            segmentations.append(this_segment)
        seq["segmentations"] = segmentations

    with open(output_json_path, "w") as f:
        json.dump(json_dict, f)


if __name__ == "__main__":
    main()
