"""Multi-scale score merging (the port's counterpart of
scripts/merge_multi_scale.py; reference scripts/merge_multi_scale.py:27-71).

Sums the per-scale uint8 score dumps (.npz, as utils/results.py writes
them) of every frame, takes the argmax, maps it back to object ids through
the video's saved backward mapping, saves palette PNGs and zips the result.

  python -m cutie_tpu_torch.scripts.merge_multi_scale --dataset Y \
      --list scoreDir1 scoreDir2 --output out_dir
"""
import multiprocessing
import os
import shutil
from argparse import ArgumentParser
from functools import partial
from os import path

import numpy as np

from cutie_tpu_torch.utils.image_io import write_png
from cutie_tpu_torch.utils.palette import davis_palette, youtube_palette


def _load_backward_mapping(vid_dir: str):
    """{object_id -> tmp_index} saved with the video's last frame, or None."""
    npz = path.join(vid_dir, "backward.npz")
    if not path.exists(npz):
        return None
    raw = dict(np.load(npz))
    return {int(k): int(v) for k, v in raw.items()}


def merge_video(vid: str, score_dirs, out_root: str, dataset: str, palette):
    """Sum this video's per-scale dumps, argmax, remap ids, write PNGs."""
    vid_dir = next((path.join(d, vid) for d in score_dirs
                    if path.exists(path.join(d, vid))), None)
    backward = _load_backward_mapping(vid_dir) if vid_dir else None

    out_dir = (path.join(out_root, "Annotations", vid)
               if "Y" in dataset else path.join(out_root, vid))
    os.makedirs(out_dir, exist_ok=True)

    frames = sorted(f for f in os.listdir(path.join(score_dirs[0], vid))
                    if f.endswith(".npz") and not f.startswith("backward"))
    for frame in frames:
        total = None
        for d in score_dirs:
            p = path.join(d, vid, frame)
            if path.exists(p):
                prob = np.load(p)["prob"].astype(np.float32)
                total = prob if total is None else total + prob
        winner = np.argmax(total, axis=0)
        if backward is not None:
            mask = np.zeros_like(winner, dtype=np.uint8)
            for obj_id, tmp_idx in backward.items():
                mask[winner == tmp_idx] = obj_id
        else:
            mask = winner.astype(np.uint8)
        write_png(path.join(out_dir, frame[:-4] + ".png"), mask, palette)


def merge(score_dirs, output: str, dataset: str = "Y", num_proc: int = 8):
    """Merge every video of score_dirs[0] into `output`, then zip it."""
    palette = youtube_palette if "Y" in dataset else davis_palette
    videos = sorted(os.listdir(score_dirs[0]))
    os.makedirs(output, exist_ok=True)
    work = partial(merge_video, score_dirs=score_dirs, out_root=output,
                   dataset=dataset, palette=palette)
    if num_proc > 1:
        with multiprocessing.get_context("spawn").Pool(num_proc) as pool:
            pool.map(work, videos)
    else:
        for vid in videos:
            work(vid)
    if "Y" in dataset:
        print("Making zip for YouTubeVOS...")
        shutil.make_archive(output, "zip", output, "Annotations")
    else:
        print("Making zip for DAVIS...")
        shutil.make_archive(output, "zip", output)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset", default="Y",
                        help="D/Y: D for DAVIS, Y for YouTubeVOS")
    parser.add_argument("--list", nargs="+", help="score directories to merge")
    parser.add_argument("--output", required=True)
    parser.add_argument("--num_proc", type=int, default=8)
    args = parser.parse_args(argv)
    merge(args.list, args.output, args.dataset, args.num_proc)


if __name__ == "__main__":
    main()
