"""Trainer: parameter groups, LR schedules, the AdamW step, checkpoints.

The port's counterpart of cutie_tpu/training/trainer.py (reference
cutie/model/trainer.py:22-246 and cutie/model/utils/parameter_groups.py).
AdamW in three parameter groups (backbone at a reduced LR, embeddings
without weight decay, the rest), after a global-norm gradient clip. amp is
bf16 autocast inside the model's stages (models/cutie.py:_stage) with fp32
parameters and fp32 gradients, and no loss scaling, as in cutie_tpu.

torch's AdamW decays the parameter before its Adam step where optax adds
the decay to the update: one step from the same parameters computes the
same update. clip_grad_norm_ divides by the norm plus 1e-6 where optax
divides by the norm.

Data parallelism (cutie_tpu trainer.py:89-155: replicated parameters, a
batch-sharded step): with a mesh, each rank holds a replica and its rows
of the global batch. The parameters are broadcast from rank 0 at
construction and after a checkpoint load; after the backward the gradients
are averaged across the mesh in one coalesced all-reduce, so that the clip
and the step see the global batch's gradient on every rank and the
replicas stay bit-equal. An explicit all-reduce and not
DistributedDataParallel: every parameter keeps a gradient every step (zero
where the step does not reach it), and some steps do not reach the
deep-update GRU at all.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from cutie_tpu_torch.models.cutie import CUTIE
from cutie_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_, broadcast_
from cutie_tpu_torch.training.losses import LossComputer
from cutie_tpu_torch.training.train_forward import train_forward

log = logging.getLogger(__name__)

# parameter_groups.py:20: parameters named so get no weight decay. The port
# names an embedding table `<name>.weight` (object_transformer.query_init.
# weight), cutie_tpu a leaf `<name>`.
_EMBED_NAMES = ("summary_pos", "query_init", "query_emb", "obj_pe")

DATA_KEYS = ("frames", "first_frame_gt", "selector", "cls_gt")


def param_label(name: str) -> str:
    """A parameter's group from its torch name: 'backbone' (the pixel
    encoder, its BatchNorm affines included), 'embed' or 'other'."""
    parts = name.split(".")
    if parts[0] == "pixel_encoder":
        return "backbone"
    if parts[-1] in _EMBED_NAMES or (parts[-1] == "weight" and len(parts) > 1
                                     and parts[-2] in _EMBED_NAMES):
        return "embed"
    return "other"


def make_lr_schedule(stage_cfg) -> Callable[[int], float]:
    """LR as a function of the count of completed optimizer updates, as an
    optax schedule is evaluated: constant, poly (power 0.9 to
    num_iterations) or step (times lr_schedule_gamma from each of
    lr_schedule_steps on)."""
    base = float(stage_cfg.learning_rate)
    kind = stage_cfg.lr_schedule
    if kind == "constant":
        return lambda count: base
    if kind == "poly":
        total = stage_cfg.num_iterations
        return lambda count: base * (1 - count / total) ** 0.9
    if kind == "step":
        steps = [int(s) for s in stage_cfg.lr_schedule_steps]
        gamma = float(stage_cfg.lr_schedule_gamma)
        return lambda count: base * gamma ** sum(count >= s for s in steps)
    raise NotImplementedError(kind)


def make_optimizer(model: torch.nn.Module, stage_cfg) -> torch.optim.AdamW:
    """AdamW over the three groups of param_label; each group carries its
    name and its LR ratio (the LR is set from the schedule each step)."""
    wd = float(stage_cfg.weight_decay)
    settings = {"backbone": (float(stage_cfg.backbone_lr_ratio), wd),
                "embed": (1.0, float(stage_cfg.embed_weight_decay)),
                "other": (1.0, wd)}
    members = {label: [] for label in settings}
    for name, p in model.named_parameters():
        members[param_label(name)].append(p)
    base = float(stage_cfg.learning_rate)
    groups = [{"params": members[label], "name": label, "lr_ratio": ratio,
               "lr": base * ratio, "weight_decay": decay}
              for label, (ratio, decay) in settings.items() if members[label]]
    return torch.optim.AdamW(groups, lr=base,
                             eps=1e-6 if stage_cfg.amp else 1e-8)


class Trainer:
    """Holds the model and its optimizer and runs training steps on the
    model's device."""

    def __init__(self, cfg, stage_cfg, model: CUTIE, mesh: Optional[Mesh] = None):
        """mesh: the data-parallel ranks (parallel.mesh.make_mesh), whose
        batches are each rank's rows of the global batch, in rank order."""
        if (model.compute_dtype == torch.bfloat16) != bool(stage_cfg.amp):
            raise ValueError(
                f"stage {stage_cfg.get('name')} has amp={stage_cfg.amp} but the "
                f"model computes in {model.compute_dtype}; build it with "
                f"cfg.amp = stage_cfg.amp")
        self.stage_cfg = stage_cfg
        self.model = model
        self.mesh = mesh
        self.device = model.pixel_mean.device
        self.loss_computer = LossComputer(cfg, stage_cfg)
        self.optimizer = make_optimizer(model, stage_cfg)
        self.schedule = make_lr_schedule(stage_cfg)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        # every parameter is updated every step, its gradient zero where the
        # step does not reach it (weight decay and the moments still move),
        # as optax updates every leaf
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.it = 0        # completed steps, as the caller counts them
        self.updates = 0   # optimizer updates applied: the schedule's count
        self.last_logits = None
        self.sync_replicas()

    def sync_replicas(self) -> None:
        """Every rank's model takes rank 0's parameters and buffers."""
        if self.mesh is not None:
            broadcast_(list(self.model.parameters()) + list(self.model.buffers()),
                       self.mesh)

    def upload_batch(self, data: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch on the model's device, uploaded asynchronously: each
        array is copied into pinned host memory and sent with
        non_blocking=True, so that batch i+1 uploads while step i runs
        (cutie_tpu's upload_batch). On the CPU the arrays are wrapped."""
        out = {}
        for k in DATA_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(data[k]))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def do_pass(self, data: Mapping[str, Any], it: int,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One optimization step. data: frames [B, T, 3, H, W] in [0, 1],
        first_frame_gt [B, O, H, W], selector [B, O], cls_gt [B, T, H, W]
        integer (tensors or numpy arrays). generator: a CPU torch.Generator
        for the step's random draws. Returns the losses (0-d tensors on the
        device: reading them waits for the step)."""
        data = {k: torch.as_tensor(data[k], device=self.device)
                for k in DATA_KEYS}
        rows = None
        if self.mesh is not None:
            b = data["frames"].shape[0]
            rows = (self.mesh.rank * b, self.mesh.size * b)
        out = train_forward(self.model, data, generator, self.stage_cfg, rows)
        loss_in = {"logits_low": out["logits_low"], "cls_gt": data["cls_gt"][:, 1:]}
        for k in ("sensory_logits", "q_logits"):
            if k in out:
                loss_in[k] = out[k]
        # the loss points come from a generator on the device, seeded from
        # the host generator without a device sync
        seed = int(torch.randint(2 ** 62, (), generator=generator))
        points = torch.Generator(device=self.device).manual_seed(seed)
        losses = self.loss_computer.compute(
            loss_in, data["selector"], self.loss_computer.uniform_draw(points), rows)
        self.optimizer.zero_grad(set_to_none=False)
        losses["total_loss"].backward()
        self.average_gradients()
        self.apply_gradients()
        self.last_logits = out["logits"].detach()
        # the completed-step count (cutie_tpu's trainer.it): a checkpoint
        # records it, and a resumed run continues from it
        self.it = it + 1
        return {k: v.detach() for k, v in losses.items()}

    def average_gradients(self) -> None:
        """The gradients averaged across the mesh: each rank's loss is the
        mean over its rows, so with equal rows a rank the average is the
        global batch's gradient."""
        if self.mesh is not None:
            all_reduce_mean_([p.grad for p in self.params], self.mesh)

    def apply_gradients(self) -> None:
        """Clip the gradients by their global norm, set each group's LR from
        the schedule at the count of updates so far, and take the AdamW
        step."""
        torch.nn.utils.clip_grad_norm_(self.params, self.stage_cfg.clip_grad_norm)
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_ratio"]
        self.optimizer.step()
        self.updates += 1

    # ------------------------------------------------------------ checkpoints

    def get_state_dict(self) -> Dict[str, np.ndarray]:
        """The model's state dict in torch names, as numpy arrays."""
        return {k: v.detach().cpu().numpy()
                for k, v in self.model.state_dict().items()}

    def save_weights(self, path: str) -> None:
        """A torch-named npz that build_model loads strictly."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **self.get_state_dict())
        log.info("weights saved to %s", path)

    def save_checkpoint(self, path: str) -> None:
        """Model, optimizer, the step count and the update count."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({"it": self.it, "updates": self.updates,
                    "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict()}, path)
        log.info("checkpoint saved to %s", path)

    def load_checkpoint(self, path: str) -> int:
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.it = int(ckpt["it"])
        self.updates = int(ckpt["updates"])
        self.sync_replicas()
        log.info("checkpoint loaded from %s (it=%d)", path, self.it)
        return self.it
