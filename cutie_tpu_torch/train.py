"""Two-stage training: the configuration.

The port's counterpart of the configuration part of cutie_tpu/train.py
(reference cutie/config/train_config.yaml and cutie/config/data/*.yaml):
train_config, the data presets and apply_data_preset. The stages are
pre_training (static images, a single-object model) and main_training
(video, three objects), with the weights handed from one to the next
through utils/get_default_model.py:apply_object_surgery.

run_stage and main, which drive the data pipeline, come with the port of
that pipeline (cutie_tpu/data/*); until then a stage is run by
training/trainer.py:Trainer.do_pass on batches made in memory.
"""
from __future__ import annotations

from os import path

from cutie_tpu_torch.config import Config, model_base

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
