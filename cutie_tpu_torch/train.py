"""Two-stage training entry point.

The port's counterpart of cutie_tpu/train.py (reference cutie/train.py and
cutie/config/train_config.yaml, data/*.yaml): pre_training (static images,
a single-object model), then main_training (video, three objects), the
weights handed from one to the next through
utils/get_default_model.py:apply_object_surgery; per-stage seeding, the
max_skip curriculum that rebuilds the loader, resumption from a
checkpoint, image grids, weights and checkpoints at their intervals, and a
crash-save guard.

    python -m cutie_tpu_torch.train exp_id=first data.vos_datasets.base=... [overrides] [device=cpu]
    torchrun --nproc_per_node=N -m cutie_tpu_torch.train ... [device=cpu]

It trains on the card; device=cpu asks for the CPU. Without a card and
without device=cpu it raises. Under torchrun (WORLD_SIZE > 1) each rank
joins the process group (NCCL on the cards, rank r on card LOCAL_RANK;
gloo on the CPU) and trains data-parallel: its rows of each global batch,
gradients averaged across the ranks (training/trainer.py); rank 0 alone
logs and saves. dist_init=<url> gives the rendezvous where torchrun's
MASTER_ADDR is not set (e.g. file:///tmp/rendezvous).
"""
from __future__ import annotations

import logging
import os
import sys
import time
from os import path
from typing import Dict, List, Optional

import numpy as np
import torch

from cutie_tpu_torch.config import Config, model_base, model_small

log = logging.getLogger("train")

# package-relative subset and empty-mask index files (the port's copy of
# cutie_tpu/utils/subsets/)
_SUBSETS = path.join(path.dirname(path.abspath(__file__)), "utils", "subsets")


def _subset(name: str) -> str:
    return path.join(_SUBSETS, name)


# data presets (reference cutie/config/data/{base,with-mose,mega}.yaml):
# each sets the main-training dataset mix + iteration schedule
DATA_PRESETS = {
    "base": {"datasets": ["DAVIS", "YouTubeVOS"],
             "num_iterations": 125000, "lr_schedule_steps": [100000, 115000]},
    "with-mose": {"datasets": ["DAVIS", "YouTubeVOS", "MOSE"],
                  "num_iterations": 125000,
                  "lr_schedule_steps": [100000, 115000]},
    "mega": {"datasets": ["DAVIS", "YouTubeVOS", "MOSE", "BURST", "OVIS"],
             "num_iterations": 175000,
             "lr_schedule_steps": [140000, 160000]},
}


def apply_data_preset(cfg: Config, preset: str) -> None:
    """Overlay a data preset onto cfg (hydra `data=<preset>` group semantics:
    the group writes into main_training's schedule, cutie/config/data/mega.yaml)."""
    p = DATA_PRESETS[preset]
    cfg.data.main_training.merge({"datasets": list(p["datasets"]),
                                  "num_iterations": p["num_iterations"],
                                  "lr_schedule_steps": list(p["lr_schedule_steps"])})
    cfg.main_training.merge({"num_iterations": p["num_iterations"],
                             "lr_schedule_steps": list(p["lr_schedule_steps"])})


def train_config() -> Config:
    """Mirrors reference cutie/config/train_config.yaml + data/base.yaml."""
    return Config({
        "model": model_base(),
        "exp_id": "default",
        "debug": False,
        "weights": None,
        "checkpoint": None,
        "seed": 14159265,
        "num_workers": 16,
        "single_object_pretraining": True,
        "log_text_interval": 100,
        "log_image_interval": 1500,
        "save_weights_interval": 10000,
        "save_checkpoint_interval": 10000,
        "data": {
            "image_datasets": {
                "base": "../static",
                "FSS": {"directory": "fss", "data_structure": 0, "multiplier": 1},
                "DUTS_TR": {"directory": "DUTS-TR", "data_structure": 1, "multiplier": 1},
                "DUTS_TE": {"directory": "DUTS-TE", "data_structure": 1, "multiplier": 1},
                "ECSSD": {"directory": "ecssd", "data_structure": 1, "multiplier": 1},
                "BIG": {"directory": "BIG_small", "data_structure": 1, "multiplier": 5},
                "HRSOD": {"directory": "HRSOD_small", "data_structure": 1, "multiplier": 5},
            },
            "preset": "base",
            "vos_datasets": {
                # full registry, reference cutie/config/data/datasets.yaml:28-80
                "base": "../",
                "DAVIS": {
                    "image_directory": "DAVIS/2017/trainval/JPEGImages/480p",
                    "mask_directory": "DAVIS/2017/trainval/Annotations/480p",
                    "multiplier": 2, "frame_interval": 2,
                    "subset": _subset("davis_train.txt"),
                    "empty_masks": _subset("davis_empty_masks.txt"),
                },
                "YouTubeVOS": {
                    "image_directory": "YouTube/train/JPEGImages",
                    "mask_directory": "YouTube/train/Annotations",
                    "multiplier": 1, "frame_interval": 5,
                    "subset": _subset("yv_train.txt"),
                    "empty_masks": _subset("yv_empty_masks.txt"),
                },
                "MOSE": {
                    "image_directory": "MOSE/train/JPEGImages",
                    "mask_directory": "MOSE/train/Annotations",
                    "multiplier": 1, "frame_interval": 5,
                    "subset": None,
                    "empty_masks": _subset("mose_empty_masks.txt"),
                },
                "BURST": {
                    "image_directory": "BURST/train-vos/JPEGImages",
                    "mask_directory": "BURST/train-vos/Annotations",
                    "multiplier": 1, "frame_interval": 5,
                    "subset": None,
                    "empty_masks": _subset("burst_empty_masks.txt"),
                },
                "OVIS": {
                    "image_directory": "OVIS-VOS-train/JPEGImages",
                    "mask_directory": "OVIS-VOS-train/Annotations",
                    "multiplier": 1, "frame_interval": 3,
                    "subset": None,
                    "empty_masks": _subset("ovis_empty_masks.txt"),
                },
            },
            "pre_training": {"datasets": ["FSS", "DUTS_TR", "DUTS_TE", "ECSSD",
                                          "BIG", "HRSOD"]},
            "main_training": {"datasets": ["DAVIS", "YouTubeVOS"],
                              "num_iterations": 125000,
                              "lr_schedule_steps": [100000, 115000]},
        },
        "pre_training": {
            "name": "pre_training", "enabled": True, "batch_size": 16,
            "amp": False, "num_iterations": 80000, "learning_rate": 1e-4,
            "lr_schedule": "constant", "point_supervision": True,
            "train_num_points": 8192, "oversample_ratio": 3.0,
            "importance_sample_ratio": 0.75, "clip_grad_norm": 3.0,
            "weight_decay": 0.001, "embed_weight_decay": 0.0,
            "backbone_lr_ratio": 0.1, "num_ref_frames": 2, "seq_length": 3,
            "remat": True,
            "num_objects": 1, "deep_update_prob": 0.2, "crop_size": [384, 384],
            "frequent_save_in_last": 0, "frequent_save_interval": 1000,
        },
        "main_training": {
            "name": "main_training", "enabled": True, "batch_size": 16,
            "amp": True, "num_iterations": 125000, "learning_rate": 1e-4,
            "lr_schedule": "step", "lr_schedule_steps": [100000, 115000],
            "lr_schedule_gamma": 0.1, "point_supervision": True,
            "train_num_points": 12544, "oversample_ratio": 3.0,
            "importance_sample_ratio": 0.75, "clip_grad_norm": 3.0,
            "weight_decay": 0.001, "embed_weight_decay": 0.0,
            "backbone_lr_ratio": 0.1, "num_ref_frames": 3, "seq_length": 8,
            "remat": True,
            "num_objects": 3, "deep_update_prob": 0.2, "crop_size": [480, 480],
            "merge_probability": 0.5, "max_skip_schedule": [5, 10, 15, 5],
            "max_skip_schedule_fraction": [0.0, 0.1, 0.3, 0.8],
            "frequent_save_in_last": 0, "frequent_save_interval": 1000,
        },
    })


def step_generator(seed: int, it: int) -> torch.Generator:
    """The CPU generator of step `it` of a stage seeded with `seed`: a pure
    function of both, so that a resumed run draws what the run it resumes
    would have drawn (it takes the place of cutie_tpu's jax.random.split)."""
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF))


def run_stage(cfg, stage_cfg, state_dict: Optional[Dict[str, np.ndarray]],
              run_path: str, logger, device: str = "cuda",
              trace: Optional[List[dict]] = None) -> Dict[str, np.ndarray]:
    """Train one stage from `state_dict` (torch names; None: a random
    initialisation from the stage seed) and return the trained state dict.
    A checkpoint in cfg.checkpoint is resumed (epoch and curriculum
    position fast-forwarded) and then cleared, so that it applies to the
    first stage only. `trace`, when given, receives one record a step:
    it, epoch, max_skip, the ms spent waiting for the loader and the ms of
    the step, and the losses."""
    from cutie_tpu_torch.data.setup_training_data import (setup_main_training_datasets,
                                                          setup_pre_training_datasets)
    from cutie_tpu_torch.parallel.mesh import make_mesh, process_rank
    from cutie_tpu_torch.training.trainer import Trainer
    from cutie_tpu_torch.utils.get_default_model import build_model
    from cutie_tpu_torch.utils.image_saver import vis_sequence
    from cutie_tpu_torch.utils.log_integrator import Integrator
    from cutie_tpu_torch.utils.time_estimator import TimeEstimator

    device = torch.device(device)
    stage = stage_cfg.name
    seed = cfg.seed + (0 if stage == "pre_training" else 1)
    single_object = (stage_cfg.num_objects == 1
                     and cfg.get("single_object_pretraining", True))
    # amp: bf16 autocast inside the model's stages with fp32 parameters
    model_cfg = cfg.copy()
    model_cfg.amp = bool(stage_cfg.amp)
    torch.manual_seed(seed)
    model = build_model(model_cfg, device=device, state_dict=state_dict,
                        single_object=single_object)
    # data parallelism over every rank, each taking its rows of the global
    # batch (cutie_tpu/train.py:188-194; the loader raises when the batch
    # does not divide across the ranks)
    mesh = make_mesh() if torch.distributed.is_initialized() else None
    trainer = Trainer(model_cfg, stage_cfg, model, mesh=mesh)
    if cfg.checkpoint is not None:
        # resume applies to the first enabled stage only (reference
        # train.py:84-89 loads then clears): a pre_training checkpoint must
        # not be loaded into main_training over the handed-off weights
        trainer.load_checkpoint(cfg.checkpoint)
        cfg.checkpoint = None
    rank, _ = process_rank()

    integrator = Integrator(logger)
    logger.time_estimator = TimeEstimator(stage_cfg.num_iterations,
                                          cfg.log_text_interval)

    max_skip_values = stage_cfg.get("max_skip_schedule", [0])
    max_skip_fracs = stage_cfg.get("max_skip_schedule_fraction", [0.0])

    def build_loader(max_skip):
        if stage == "pre_training":
            return setup_pre_training_datasets(cfg, stage_cfg, seed=seed)[1]
        return setup_main_training_datasets(cfg, stage_cfg, max_skip, seed=seed)[1]

    total_iter = stage_cfg.num_iterations
    skip_i = 0
    loader = build_loader(max_skip_values[0])
    it = trainer.it
    # checkpoint resume: fast-forward the deterministic stream to the epoch
    # the run stopped in (reference train.py: current_epoch = curr_iter //
    # len(loader)), and the curriculum pointer to its max_skip
    epoch = it // max(loader.batches_per_epoch(), 1)
    while (stage == "main_training" and skip_i < len(max_skip_fracs) - 1
           and it >= max_skip_fracs[skip_i + 1] * total_iter):
        skip_i += 1
    if skip_i > 0:
        loader = build_loader(max_skip_values[skip_i])

    def next_batch(batches):
        """The next batch, uploaded (asynchronously on the card), with the
        host frames and class maps kept for the image grids, and the ms
        spent waiting for it."""
        t0 = time.perf_counter()
        data = next(batches, None)
        wait = 1e3 * (time.perf_counter() - t0)
        if data is None:
            return None
        data.pop("info", None)
        return trainer.upload_batch(data), data["cls_gt"], data["frames"], wait

    try:
        while it < total_iter:
            batches = iter(loader.epoch(epoch))
            nxt = next_batch(batches)
            while nxt is not None:
                data_dev, cls_gt, host_frames, wait_ms = nxt
                # max_skip curriculum: rebuild the loader at the schedule's
                # points (train.py:102-119, 142-149)
                if (stage == "main_training"
                        and skip_i < len(max_skip_fracs) - 1
                        and it >= max_skip_fracs[skip_i + 1] * total_iter):
                    skip_i += 1
                    loader = build_loader(max_skip_values[skip_i])
                    break
                t0 = time.perf_counter()
                losses = trainer.do_pass(data_dev, it, step_generator(seed, it))
                # the next batch uploads while this step runs on the card
                nxt = next_batch(batches)
                losses = {k: float(v) for k, v in losses.items()}  # waits for the step
                integrator.add_dict(losses)
                if trace is not None:
                    trace.append({"it": it, "epoch": epoch,
                                  "max_skip": max_skip_values[skip_i],
                                  "wait_ms": wait_ms,
                                  "step_ms": 1e3 * (time.perf_counter() - t0),
                                  "losses": losses})
                it += 1
                if it % cfg.log_text_interval == 0:
                    integrator.finalize(f"train/{stage}", it)
                    integrator.reset_except_hooks()
                if it % cfg.log_image_interval == 0 and rank == 0:
                    # image/GT/prediction grids (reference trainer.py:113-118)
                    grid = vis_sequence({"frames": host_frames, "cls_gt": cls_gt},
                                        trainer.last_logits.float().cpu().numpy())
                    logger.log_image(f"train/{stage}", grid, it)
                if it % cfg.save_weights_interval == 0 and rank == 0:
                    trainer.save_weights(path.join(run_path, f"weights_{it}.npz"))
                if it % cfg.save_checkpoint_interval == 0 and rank == 0:
                    trainer.save_checkpoint(path.join(run_path, "checkpoint.pt"))
                if it >= total_iter:
                    break
            batches.close()   # an epoch left early stops its decoding
            epoch += 1
    finally:
        # crash-save guard (train.py:157-160)
        if rank == 0:
            trainer.save_weights(path.join(run_path, f"weights_{stage}_final.npz"))
            trainer.save_checkpoint(path.join(run_path, "checkpoint_final.pt"))
    return trainer.get_state_dict()


def setup_rank_logging(run_path: str) -> None:
    """Per-rank log files with rank-tagged formatters (reference
    cutie/config/hydra/job_logging/custom.yaml:4-16)."""
    from cutie_tpu_torch.parallel.mesh import process_rank

    rank, _ = process_rank()
    fmt = logging.Formatter(
        f"[%(asctime)s][%(levelname)s][r{rank}] - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    stream = logging.StreamHandler()
    stream.setFormatter(fmt)
    root.addHandler(stream)
    os.makedirs(run_path, exist_ok=True)
    fh = logging.FileHandler(path.join(run_path, f"train_rank{rank}.log"))
    fh.setFormatter(fmt)
    root.addHandler(fh)


def main(argv=None):
    from cutie_tpu_torch.parallel.launch import join_launch, pop_launch_args

    argv = list(sys.argv[1:] if argv is None else argv)
    device, dist_init = pop_launch_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on the card, and torch.cuda.is_available() "
                           "is False; pass device=cpu to train on the CPU")
    device, joined = join_launch(device, dist_init)
    try:
        return _train(argv, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(argv: List[str], device: torch.device):
    from cutie_tpu_torch.parallel.mesh import process_rank
    from cutie_tpu_torch.utils.get_default_model import (apply_object_surgery,
                                                         load_torch_npz)
    from cutie_tpu_torch.utils.logger import TensorboardLogger

    cfg = train_config()
    cfg.apply_overrides(argv)
    # data=<preset> (base / with-mose / mega) overlays the main-training
    # dataset mix and schedule; explicit overrides then apply again on top
    if cfg.data.preset != "base":
        apply_data_preset(cfg, cfg.data.preset)
        cfg.apply_overrides(argv)
    # model=<small|base> stores a string; resolve it after every override
    # pass, as hydra resolves groups before overrides
    if isinstance(cfg.get("model"), str):
        cfg.model = model_small() if cfg.model == "small" else model_base()

    run_path = path.join("output", cfg.exp_id)
    setup_rank_logging(run_path)
    rank, _ = process_rank()
    logger = TensorboardLogger(path.join(run_path, "tb"), enabled=rank == 0)
    logger.log_string("config", str(cfg.to_dict()))

    np.random.seed(cfg.seed)
    state_dict = load_torch_npz(cfg.weights) if cfg.weights is not None else None
    for stage_name in ("pre_training", "main_training"):
        stage_cfg = cfg[stage_name]
        if not stage_cfg.enabled:
            continue
        log.info("=== stage %s ===", stage_name)
        state_dict = run_stage(cfg, stage_cfg, state_dict, run_path, logger, device)
        if torch.distributed.is_initialized():
            # every rank has finished the stage (rank 0 has saved it)
            torch.distributed.barrier()
        if stage_name == "pre_training" and stage_cfg.num_objects == 1:
            # single- to multi-object surgery for the hand-off
            # (reference cutie/model/cutie.py:212-256)
            state_dict = apply_object_surgery(state_dict, False, cfg.model.sensory_dim,
                                              cfg.model.value_dim)
    return state_dict


if __name__ == "__main__":
    main()
