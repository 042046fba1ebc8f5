"""Keep only the FIRST annotation of every object, to bring LVOS masks to
the test format (the port's counterpart of scripts/data/preprocess_lvos.py).

For each video, in frame order, a mask is written only where it holds
labels no earlier mask held, and then with only those labels; palette
masks keep their palette (a mask without one is written as it was read,
grayscale or colour). The videos run in a pool of 8 processes.

  python -m cutie_tpu_torch.scripts.data.preprocess_lvos input_annotations out_dir
"""
import os
import sys
from functools import partial
from multiprocessing import Pool

import numpy as np

from cutie_tpu_torch.utils.image_io import read_any, write_png


def process_vid(input_dir: str, output_dir: str, video_name: str) -> None:
    os.makedirs(os.path.join(output_dir, video_name), exist_ok=True)
    existing = set()
    for f in sorted(os.listdir(os.path.join(input_dir, video_name))):
        pixels, _, palette = read_any(os.path.join(input_dir, video_name, f))
        mask = pixels.astype(np.uint8)
        labels = np.unique(mask)
        new_labels = [lb for lb in labels[labels != 0].tolist() if lb not in existing]
        if new_labels:
            existing.update(new_labels)
            out = np.zeros_like(mask)
            for lb in new_labels:
                out[mask == lb] = lb
            write_png(os.path.join(output_dir, video_name, f), out, palette)


def main(argv=None) -> None:
    input_dir, output_dir = sys.argv[1:3] if argv is None else argv[:2]
    videos = sorted(os.listdir(input_dir))
    with Pool(8) as p:
        list(p.imap(partial(process_vid, input_dir, output_dir), videos))


if __name__ == "__main__":
    main()
