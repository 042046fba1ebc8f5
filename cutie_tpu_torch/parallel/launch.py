"""Starting ranks: the entry points' launch arguments, and a function run
on several ranks of one host, each a spawned process.

    device, dist_init = pop_launch_args(argv)   # device=..., dist_init=...
    device, joined = join_launch(device, dist_init)   # under torchrun
    results = spawn_ranks(fn, world=2, device="cpu", args=(...))

Each rank is a fresh interpreter (multiprocessing's spawn context), joins
a process group through a file:// rendezvous in a temporary directory (no
port to collide with), calls fn(*args) and returns what fn returns (saved
with torch.save: tensors on the CPU, numpy arrays, plain values). fn must
be importable by name from a module that the spawned process can import.
The results come back in rank order; a rank that raises or outlives the
timeout fails the call, and every rank still running is stopped.
"""
from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cutie_tpu_torch.parallel.mesh import init_distributed


def pop_launch_args(argv: List[str]) -> Tuple[str, Optional[str]]:
    """Remove device=<dev> (default 'cuda') and dist_init=<url> (default
    None) from argv; returns (device, dist_init)."""
    found = {"device": "cuda", "dist_init": None}
    for arg in list(argv):
        key, _, value = arg.partition("=")
        if key in found:
            found[key] = value
            argv.remove(arg)
    return found["device"], found["dist_init"]


def join_launch(device: str, dist_init: Optional[str]) -> Tuple[torch.device, bool]:
    """Under torchrun (WORLD_SIZE > 1): join the process group and return
    (this rank's device, True); else (device, False)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return init_distributed(device, init_method=dist_init), True
    return torch.device(device), False


def _rank_main(fn, rank: int, world: int, device: Optional[str],
               backend: Optional[str], init: Optional[str], out_dir: str, args,
               threads: Optional[int]) -> None:
    out = os.path.join(out_dir, f"rank{rank}")
    try:
        if threads:
            torch.set_num_threads(threads)
        if init is None:
            # torchrun's environment, for an entry point that joins itself
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                              LOCAL_RANK=str(rank))
        else:
            init_distributed(device, backend=backend, init_method=init, rank=rank,
                             world_size=world)
        result = fn(*args)
        if init is not None:
            dist.barrier()
            dist.destroy_process_group()
        torch.save({"result": result}, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world: int, *, device: Optional[str] = "cpu",
                backend: Optional[str] = None, args: Sequence[Any] = (),
                timeout: float = 600.0, threads: Optional[int] = None,
                join: bool = True) -> List[Any]:
    """fn(*args) on `world` spawned ranks; their results in rank order.
    device: 'cpu', 'cuda' (rank r on card r) or a named card ('cuda:0':
    every rank on it, with backend 'gloo'); threads: torch's intra-op
    threads a rank. join=False starts the ranks outside any group, with
    torchrun's RANK, WORLD_SIZE and LOCAL_RANK set, for fn to join."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cutie_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous") if join else None
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, device, backend, init, tmp, tuple(args),
                               threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        # wait for every rank; one that fails leaves the others blocked in a
        # collective, so the first failure ends the wait
        deadline = time.monotonic() + timeout
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.05)
        for p in procs:
            if p.exitcode:
                for q in procs:
                    q.join(2.0)   # the others' error files, if they fail too
                break
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.is_alive():
                errors.append(f"rank {r}: did not finish")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("spawn_ranks: " + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)["result"] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
