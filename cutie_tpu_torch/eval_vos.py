"""Benchmark evaluation entry point (the port's counterpart of
cutie_tpu/eval_vos.py; reference cutie/eval_vos.py:23-176).

    python -m cutie_tpu_torch.eval_vos dataset=d17-val weights=cutie-base-mega.pth \
        image_directory=... mask_directory=... size=480 [device=cpu]

It runs on the card; `device=cpu` (or eval_vos(cfg, device="cpu")) asks
for the CPU. Each frame's step is timed alone, between
torch.cuda.synchronize() calls; FPS and the peak device memory are logged
at the end. Under torch.distributed, videos are strided by rank.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from os import path

import torch
import torch.distributed as dist

from cutie_tpu_torch.config import (eval_config, get_dataset_cfg, model_base,
                                    model_small)
from cutie_tpu_torch.data.burst import BURSTResultHandler, BURSTTestDataset
from cutie_tpu_torch.data.prefetch import prefetch_iter
from cutie_tpu_torch.data.video_reader import VOSTestDataset
from cutie_tpu_torch.inference import InferenceCore
from cutie_tpu_torch.utils.get_default_model import build_model
from cutie_tpu_torch.utils.results import ResultSaver, make_zip

log = logging.getLogger(__name__)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_vos(cfg, device: str = "cuda") -> dict:
    """Segment every video of cfg.dataset and save the results under
    cfg.output_dir. Returns {'fps', 'total_frames'}."""
    device = torch.device(device)
    run_dir = cfg.output_dir or path.join("output", cfg.exp_id, cfg.dataset)
    os.makedirs(run_dir, exist_ok=True)
    log.info("All configuration: %s", cfg.to_dict())

    dataset_name = cfg.dataset
    data_cfg = get_dataset_cfg(cfg)
    is_burst = "burst" in dataset_name

    network = build_model(cfg, cfg.weights, device)
    if not cfg.weights or not path.exists(str(cfg.weights)):
        log.warning("No model weights loaded. Are you sure about this?")

    image_dir = data_cfg.image_directory
    json_dir = data_cfg.get("json_directory")
    size_dir = data_cfg.get("size_directory")
    if is_burst:
        meta_dataset = BURSTTestDataset(image_dir, json_dir, size=data_cfg.size,
                                        skip_frames=data_cfg.skip_frames)
        burst_handler = BURSTResultHandler(meta_dataset.json)
    else:
        meta_dataset = VOSTestDataset(image_dir, data_cfg.mask_directory,
                                      use_all_masks=data_cfg.use_all_masks,
                                      req_frames_json=json_dir,
                                      size=data_cfg.size, size_dir=size_dir,
                                      subset=data_cfg.get("subset"))

    save_all = data_cfg["save_all"]
    mask_output_root = path.join(run_dir, "Annotations")
    score_output_root = path.join(run_dir, "Scores")
    visualize_output_root = path.join(run_dir, "Visualizations")

    total_process_time = 0.0
    total_frames = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # videos are independent: each process takes every rank-th one
    distributed = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if distributed else (0, 1)

    for vid_reader in meta_dataset.get_datasets(process_index=rank,
                                                 process_count=world):
        vid_name = vid_reader.vid_name
        vid_length = len(vid_reader)
        log.info("Processing %s (%d frames)", vid_name, vid_length)

        processor = InferenceCore(network, cfg)
        saver = ResultSaver(
            mask_output_root, vid_name, dataset=dataset_name,
            object_manager=processor.object_manager,
            use_long_id=vid_reader.use_long_id, palette=vid_reader.get_palette(),
            save_scores=cfg.save_scores, score_output_root=score_output_root,
            visualize_output_root=visualize_output_root, visualize=cfg.visualize,
            init_json=vid_reader.sequence_json if is_burst else None)
        first_mask_loaded = False

        try:
            # the next frame is decoded in prefetch_iter's threads and
            # uploaded once the step before it has been timed
            stream = prefetch_iter(vid_reader, num_workers=4)
            buf = next(stream, None)
            image = None if buf is None else torch.from_numpy(buf["rgb"]).to(device)
            ti = -1
            while buf is not None:
                ti += 1
                data = buf
                mask = data.get("mask")
                valid_labels = data.get("valid_labels")
                if valid_labels is not None:
                    valid_labels = [int(x) for x in valid_labels]
                info = data["info"]

                skip = not first_mask_loaded and mask is None
                if mask is not None:
                    first_mask_loaded = True
                if not skip:
                    # the timed window is the step alone (the reference's
                    # CUDA-event timing): it returns before the card is done
                    _sync(device)
                    t0 = time.perf_counter()
                    prob = processor.step(image, mask, valid_labels,
                                          end=(ti == vid_length - 1))
                    _sync(device)
                    total_process_time += time.perf_counter() - t0
                    total_frames += 1
                buf = next(stream, None)
                if buf is not None:
                    image = torch.from_numpy(buf["rgb"]).to(device)
                if skip:
                    continue

                if save_all or info["save"]:
                    saver.process(prob, info["frame"],
                                  resize_needed=info["resize_needed"],
                                  shape=info["shape"],
                                  last_frame=(ti == vid_length - 1),
                                  path_to_image=info["path_to_image"])
            saver.end()
            if is_burst:
                burst_handler.add_sequence(saver.video_json)
        except Exception as e:
            log.error("Runtime error at %s: %s", vid_name, e)
            saver.end()
            raise

    log.info("Total processing time: %s", total_process_time)
    log.info("Total processed frames: %s", total_frames)
    fps = total_frames / total_process_time if total_process_time else 0.0
    log.info("FPS: %s", fps)
    if device.type == "cuda":
        log.info("Peak device memory (MB): %s",
                 torch.cuda.max_memory_allocated(device) / 2 ** 20)

    if world > 1:
        # every rank has written its masks before rank 0 zips; each BURST
        # handler holds its own videos, so each writes its own file
        dist.barrier()
        if is_burst:
            burst_handler.dump(run_dir, suffix=f"_rank{rank}")
        if rank == 0:
            make_zip(dataset_name, run_dir, cfg.exp_id, mask_output_root)
    else:
        make_zip(dataset_name, run_dir, cfg.exp_id, mask_output_root)
        if is_burst:
            burst_handler.dump(run_dir)
    return {"fps": fps, "total_frames": total_frames}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for arg in [a for a in argv if a.startswith("device=")]:
        device = arg.partition("=")[2]
        argv.remove(arg)
    cfg = eval_config("base")
    cfg.apply_overrides(argv)
    # model=small / model=base selects the preset
    if isinstance(cfg.get("model"), str):
        cfg.model = model_small() if cfg.model == "small" else model_base()
    return eval_vos(cfg, device)


if __name__ == "__main__":
    main()
