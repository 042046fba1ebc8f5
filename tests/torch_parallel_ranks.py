"""What the spawned ranks of tests/test_torch_parallel.py and
tests/test_torch_ddp.py run (cutie_tpu_torch.parallel.launch.spawn_ranks).

A spawned rank imports this module by name, so it imports torch, numpy and
the port only: no JAX and nothing of cutie_tpu
(tests/test_torch_package.py). Inputs are made here from numpy seeds; the
test process makes the same inputs with the same functions for its
oracles. Results go back as numpy arrays."""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from cutie_tpu_torch.config import eval_config
from cutie_tpu_torch.inference import InferenceCore
from cutie_tpu_torch.parallel import (make_mem_mesh, make_mesh, process_rank,
                                      shard_batch, shard_memory,
                                      sharded_composite_readout,
                                      sharded_topk_readout)
from cutie_tpu_torch.training.train_forward import train_forward
from cutie_tpu_torch.training.trainer import Trainer
from cutie_tpu_torch.utils.get_default_model import build_model

GOLDEN = Path(__file__).resolve().parent / "golden"
SMALL_WEIGHTS = str(GOLDEN / "state_dict_small.npz")
OUT_KEYS = ("logits", "logits_low", "sensory_logits", "q_logits")


# ------------------------------------------------------------------ reads

def read_problem(seed, b=2, n=512, p=96, o=3, ck=64, cv=32, n_valid=None):
    """tests/test_sharded_memory.py:_problem, draw for draw: mk, ms, qk,
    qe, values, valid (None, or n_valid valid tokens scattered)."""
    rng = np.random.RandomState(seed)
    mk = rng.randn(b, n, ck).astype(np.float32)
    ms = (rng.rand(b, n).astype(np.float32) ** 2 + 1.0)
    qk = rng.randn(b, p, ck).astype(np.float32)
    qe = rng.rand(b, p, ck).astype(np.float32)
    vals = rng.randn(b, o, n, cv).astype(np.float32)
    valid = None
    if n_valid is not None:
        valid = np.zeros((b, n), bool)
        valid[:, :n_valid] = True
        valid = valid[:, rng.permutation(n)]
    return mk, ms, qk, qe, vals, valid


def tie_problem(n=256):
    """A read whose k-th similarity (query 0's) is held by two tokens in
    opposite halves of the token axis, so on different ranks at any mesh
    size: the k-th token copied over the lowest-ranked token of the other
    half."""
    from cutie_tpu_torch.ops.memory import get_similarity

    mk, ms, qk, qe, vals, _ = read_problem(5, b=1, n=n, p=32)
    sim = get_similarity(*(torch.from_numpy(x) for x in (mk, ms, qk, qe)))[0, 0]
    order = torch.argsort(sim, descending=True, stable=True).tolist()
    src = order[TOPK_CASES["tie"] - 1]
    dst = next(i for i in reversed(order) if (i < n // 2) != (src < n // 2))
    mk[0, dst], ms[0, dst] = mk[0, src], ms[0, src]
    return mk, ms, qk, qe, vals, None


# case name: top_k
TOPK_CASES = {"all_valid": 30, "n_valid_200": 30, "no_shrink_no_sel": 16,
              "topk_exceeds_shard": 30, "all_invalid": 30, "bf16_values": 30,
              "tie": 30}


def topk_case(name):
    """(mk, ms, qk, qe, values, valid, top_k) of a case, numpy; values are
    rounded to bf16 (kept fp32 here) in the bf16 case."""
    if name == "all_valid":
        args = read_problem(0)
    elif name == "n_valid_200":
        args = read_problem(0, n_valid=200)
    elif name == "no_shrink_no_sel":
        mk, _, qk, _, vals, _ = read_problem(1, n=256, p=64)
        args = (mk, None, qk, None, vals, None)
    elif name == "topk_exceeds_shard":
        args = read_problem(2, n=64, p=32)
    elif name == "all_invalid":
        mk, ms, qk, qe, vals, _ = read_problem(3, n=256, p=64)
        args = (mk, ms, qk, qe, vals, np.zeros(ms.shape, bool))
    elif name == "bf16_values":
        mk, ms, qk, qe, vals, valid = read_problem(4)
        vals = torch.from_numpy(vals).bfloat16().float().numpy()
        args = (mk, ms, qk, qe, vals, valid)
    else:
        args = tie_problem()
    return args + (TOPK_CASES[name],)


def _t(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


# composite [perm | lt | work]: section sizes that do not all divide by the
# mesh (perm and work are padded); lt divides by 2 and 4
COMPOSITE_SIZES = (100, 128, 300)


def composite_case(seed=6, b=2, p=80, o=2, ck=64, cv=32):
    """Three sections (key, shrink, value, valid) and the queries, numpy."""
    rng = np.random.RandomState(seed)
    sections = []
    for n in COMPOSITE_SIZES:
        valid = rng.rand(b, n) < 0.7
        sections.append((rng.randn(b, n, ck).astype(np.float32),
                         (rng.rand(b, n).astype(np.float32) ** 2 + 1.0),
                         rng.randn(b, o, n, cv).astype(np.float32), valid))
    qk = rng.randn(b, p, ck).astype(np.float32)
    qe = rng.rand(b, p, ck).astype(np.float32)
    return sections, qk, qe


def rank_reads():
    """Every sharded read case on this rank: {name: (readout, usage of
    this rank's tokens)} and {'composite_lt_sharded' / '..._replicated':
    (readout, lt usage, work usage)}, numpy."""
    mesh = make_mem_mesh()
    out = {}
    for name in TOPK_CASES:
        mk, ms, qk, qe, vals, valid, k = topk_case(name)
        vdt = torch.bfloat16 if name == "bf16_values" else None
        mk_l, ms_l, v_l, valid_l = shard_memory(mesh, _t(mk), _t(ms), _t(vals, vdt),
                                                _t(valid))
        rd, us = sharded_topk_readout(mk_l, ms_l, _t(qk), _t(qe), v_l, valid_l, k,
                                      mesh, return_usage=True)
        out[name] = (rd.numpy(), us.numpy())
    sections, qk, qe = composite_case()
    for lt_sharded in (True, False):
        secs = [tuple(_t(x) for x in s) for s in sections]
        if lt_sharded:
            secs[1] = shard_memory(mesh, *secs[1])
        rd, lt_us, work_us = sharded_composite_readout(
            *secs, _t(qk), _t(qe), 30, mesh, lt_sharded=lt_sharded, return_usage=True)
        key = "composite_" + ("lt_sharded" if lt_sharded else "replicated")
        out[key] = (rd.numpy(), lt_us.numpy(), work_us.numpy())
    return out


# ---------------------------------------------------------------- streams

LT = {"count_usage": True, "max_mem_frames": 4, "min_mem_frames": 2,
      "num_prototypes": 32, "max_num_tokens": 256, "buffer_tokens": 64}
# tests/test_torch_lt.py's settings, the ones the small goldens were
# recorded with
STREAM_SETTINGS = {"mem_every": 3, "top_k": 30, "stagger_updates": 5,
                   "max_mem_frames": 3, "long_term": LT}


def run_stream(golden: str, long_term: bool, mem_mesh_devices: int) -> dict:
    """The small model's InferenceCore over a recorded stream: the
    probabilities [T, 3, H, W], the consolidations, the long-term slots
    this rank holds and the capacity."""
    cfg = eval_config("small")
    cfg.merge(dict(STREAM_SETTINGS, use_long_term=long_term,
                   mem_mesh_devices=mem_mesh_devices))
    core = InferenceCore(build_model(cfg, SMALL_WEIGHTS, device="cpu"), cfg)
    rec = np.load(GOLDEN / golden)
    probs = []
    for ti, frame in enumerate(rec["frames"]):
        prob = (core.step(frame, rec["mask0"], objects=[1, 2]) if ti == 0
                else core.step(frame))
        probs.append(prob.numpy())
    return {"probs": np.stack(probs), "consolidations": core.consolidations,
            "lt_slots": core.state.lt_key.shape[1], "lt_capacity": core.lt_capacity,
            "lt_count": core.state.lt_count}


def rank_streams() -> dict:
    return {name: run_stream(name, long_term, 2)
            for name, long_term in (("stream_small_work.npz", False),
                                    ("stream_small_lt.npz", True))}


# --------------------------------------------------------------- training

def tiny_batch(b=2, t=3, hw=64, o=2, seed=0) -> dict:
    """tests/test_torch_training.py:tiny_data's batch in the port's layout
    (frames [B, T, 3, H, W]), draw for draw."""
    rng = np.random.default_rng(seed)
    cls_gt = rng.integers(0, o + 1, size=(b, t, hw, hw))
    first_gt = np.moveaxis(np.eye(o + 1, dtype=np.float32)[cls_gt[:, 0]], -1, 1)[:, 1:]
    frames = rng.uniform(size=(b, t, hw, hw, 3)).astype(np.float32)
    return {"frames": np.ascontiguousarray(np.moveaxis(frames, -1, 2)),
            "first_frame_gt": first_gt, "selector": np.ones((b, o), np.float32),
            "cls_gt": cls_gt.astype(np.uint8)}


def functional_weights(seed: int, shapes: dict) -> dict:
    """tests/test_torch_training.py:_functional over the global batch's
    output shapes (channels first)."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=shapes[k]).astype(np.float32) for k in OUT_KEYS}


def grad_stage_cfg():
    from cutie_tpu_torch.train import train_config

    return train_config().main_training.merge(dict(
        seq_length=3, num_ref_frames=2, deep_update_prob=1.0, remat=False,
        amp=False))


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_functional_grads(weights: dict) -> dict:
    """The gradient of the mean over the global batch's rows of
    sum(out[k] * weights[k]), each rank running its rows (shard_batch)
    and the Trainer averaging the gradients across the ranks. Rank 0
    returns every gradient; each rank the digest of its gradients."""
    mesh = make_mesh()
    model = build_model(eval_config("small"), SMALL_WEIGHTS, device="cpu")
    stage = grad_stage_cfg()
    trainer = Trainer(eval_config("small"), stage, model, mesh=mesh)
    data = shard_batch(tiny_batch(), mesh)
    w = shard_batch(weights, mesh)
    b = len(data["frames"])
    out = train_forward(model, {k: torch.from_numpy(v) for k, v in data.items()},
                        torch.Generator().manual_seed(0), stage,
                        rows=(mesh.rank * b, mesh.size * b))
    f = sum((out[k] * torch.from_numpy(w[k])).sum() for k in OUT_KEYS) / b
    trainer.optimizer.zero_grad(set_to_none=False)
    f.backward()
    trainer.average_gradients()
    names = [n for n, _ in model.named_parameters()]
    grads = [p.grad for p in model.parameters()]
    res = {"digest": digest(grads), "rank": process_rank()}
    if mesh.rank == 0:
        res["grads"] = {n: g.numpy().copy() for n, g in zip(names, grads)}
    return res


def do_pass_stage_cfg():
    """test_do_pass_descends's stage, with a reference subset drawn at the
    last frame (num_ref_frames 1) and the default deep-update draws."""
    from cutie_tpu_torch.train import train_config

    return train_config().main_training.merge(dict(
        seq_length=3, num_ref_frames=1, train_num_points=64, num_objects=2,
        lr_schedule="constant", amp=False, remat=False))


def do_pass_steps(steps: int, world: int) -> dict:
    """`steps` Trainer.do_pass steps on tiny_batch(b=2) (this rank's rows
    under a mesh of `world` ranks, the whole batch at world 1): the
    losses, the parameters' digest after each step, and the parameters."""
    from cutie_tpu_torch.train import step_generator

    mesh = make_mesh() if world > 1 else None
    cfg = eval_config("small")
    model = build_model(cfg, SMALL_WEIGHTS, device="cpu")
    trainer = Trainer(cfg, do_pass_stage_cfg(), model, mesh=mesh)
    batch = tiny_batch()
    data = shard_batch(batch, mesh) if mesh else batch
    digests, losses = [], []
    for it in range(steps):
        loss = trainer.do_pass(data, it, step_generator(7, it))
        losses.append(float(loss["total_loss"]))
        digests.append(digest(model.parameters()))
    return {"digests": digests, "losses": losses,
            "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}


def rank_do_pass(steps: int) -> dict:
    res = do_pass_steps(steps, world=2)
    if process_rank()[0] != 0:
        del res["params"]
    return res


# ---------------------------------------------------------------- entries

def rank_train_main(run_root: str, argv: list) -> dict:
    """train.main as torchrun would start it (RANK, WORLD_SIZE and
    LOCAL_RANK set, no group yet), each rank in its own directory
    run_root/rank<r>: what process_rank() said and which rows each step
    got (a digest of its frames), and a digest of the trained weights."""
    from cutie_tpu_torch import train

    rank = int(os.environ["RANK"])
    cwd = Path(run_root) / f"rank{rank}"
    cwd.mkdir(parents=True)
    os.chdir(cwd)
    steps = []
    do_pass = Trainer.do_pass

    def recording(self, data, it, generator):
        steps.append({"rank": process_rank(), "rows": len(data["frames"]),
                      "frames": digest([data["frames"].cpu()]),
                      "mesh": None if self.mesh is None else self.mesh.size})
        return do_pass(self, data, it, generator)

    Trainer.do_pass = recording
    try:
        sd = train.main(argv)
    finally:
        Trainer.do_pass = do_pass
    return {"steps": steps, "weights": digest([torch.from_numpy(v) for v in sd.values()]),
            "grouped_after": torch.distributed.is_initialized()}


def rank_eval_main(argv: list) -> dict:
    """eval_vos.main as torchrun would start it: its result and what
    process_rank() said while the first core was built."""
    from cutie_tpu_torch import eval_vos
    from cutie_tpu_torch.inference import inference_core

    seen = []
    init = inference_core.InferenceCore.__init__

    def recording(self, network, cfg):
        seen.append(process_rank())
        init(self, network, cfg)

    inference_core.InferenceCore.__init__ = recording
    try:
        res = eval_vos.main(list(argv))
    finally:
        inference_core.InferenceCore.__init__ = init
    return dict(res, ranks_seen=seen)
