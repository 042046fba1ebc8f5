"""Stage dataset construction (pre-training statics, main-training VOS).

The port's counterpart of cutie_tpu/data/setup_training_data.py
(reference cutie/dataset/setup_training_data.py:25-87 and the
cutie/config/data/datasets.yaml registry). The loader's shard is this
process's rank in torch.distributed when that is initialised, else the
only one.
"""
from __future__ import annotations

import json
import logging
from os import path
from typing import Dict

from cutie_tpu_torch.data.loader import ShardedLoader
from cutie_tpu_torch.data.static_dataset import SyntheticVideoDataset
from cutie_tpu_torch.data.vos_dataset import VOSMergeTrainDataset
from cutie_tpu_torch.parallel.mesh import process_rank

log = logging.getLogger(__name__)


def load_subset(p: str):
    with open(p) as f:
        return set(line.strip() for line in f)


def load_empty_masks(p: str) -> Dict[str, list]:
    with open(p) as f:
        return json.load(f)


def _loader(cfg, stage_cfg, dataset, seed: int) -> ShardedLoader:
    rank, world = process_rank()
    return ShardedLoader(dataset, stage_cfg.batch_size, seed=seed,
                         num_workers=cfg.get("num_workers", 8),
                         process_index=rank, process_count=world)


def setup_pre_training_datasets(cfg, stage_cfg, seed: int = 0):
    root = cfg.data.image_datasets.base
    tuples = []
    for name in cfg.data.pre_training.datasets:
        d = cfg.data.image_datasets[name]
        tuples.append((path.join(root, d.directory), d.data_structure, d.multiplier))
    dataset = SyntheticVideoDataset(tuples, seq_length=stage_cfg.seq_length,
                                    max_num_obj=stage_cfg.num_objects,
                                    size=stage_cfg.crop_size[0])
    return dataset, _loader(cfg, stage_cfg, dataset, seed)


def setup_main_training_datasets(cfg, stage_cfg, max_skip: int, seed: int = 0):
    root = cfg.data.vos_datasets.base
    dataset_configs = {}
    for name in cfg.data.main_training.datasets:
        d = cfg.data.vos_datasets[name]
        dataset_configs[name] = {
            "im_root": path.join(root, d.image_directory),
            "gt_root": path.join(root, d.mask_directory),
            "max_skip": max_skip // d.frame_interval,
            "subset": load_subset(d.subset) if d.get("subset") else None,
            "empty_masks": (load_empty_masks(d.empty_masks)
                            if d.get("empty_masks") else None),
            "multiplier": d.multiplier,
        }
    dataset = VOSMergeTrainDataset(dataset_configs,
                                   seq_length=stage_cfg.seq_length,
                                   max_num_obj=stage_cfg.num_objects,
                                   size=stage_cfg.crop_size[0],
                                   merge_probability=stage_cfg.merge_probability)
    log.info("Using a max skip of %d frames", max_skip)
    return dataset, _loader(cfg, stage_cfg, dataset, seed)
