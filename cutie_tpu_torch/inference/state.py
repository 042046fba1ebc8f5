"""Fixed-capacity memory state for streaming inference.

The port's counterpart of cutie_tpu/inference/state.py (reference
cutie/inference/{memory_manager,kv_memory_store}.py). Every store is a
buffer of fixed capacity with validity masks:

  - permanent memory: append-only token buffer (the first frame and forced
    commits);
  - working memory: a ring of F frame slots of HW tokens each, FIFO, with
    the frames' selection and usage counters for consolidation;
  - long-term memory: an append buffer of L prototype tokens with usage
    counters, compacted by usage-ranked eviction (kv_memory_store.py:209-242);
  - sensory memory [B, O, Cs, h, w] and object memory, a streaming-average
    summary accumulator [B, O, Q, E+1].

Objects are a padded axis O; per-object validity masks [O, tokens] replace
the reference's buckets. The counters are host integers (PyTorch runs
eagerly, so there is nothing to trace). Outside long-term mode the
long-term buffers hold L = 0 tokens.

Under a memory mesh of D ranks (parallel/sharded_memory.py) each rank's
long-term buffers hold its slice of the token axis: L / D slots, rank r's
starting at global slot r * L / D (lt_shard = (r, D)). lt_count stays the
global count, so a slice's validity compares global slot indices
(lt_valid(offset)).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class MemoryState:
    sensory: torch.Tensor          # [B, O, Cs, h, w] fp32
    obj_v: torch.Tensor            # [B, O, Q, E+1] fp32
    perm_key: torch.Tensor         # [B, Pcap, Ck]
    perm_shrink: torch.Tensor      # [B, Pcap]
    perm_value: torch.Tensor       # [B, O, Pcap, Cv] fp32 (bf16 under amp)
    perm_obj_valid: torch.Tensor   # [O, Pcap] bool: token valid for object
    work_key: torch.Tensor         # [B, F, HW, Ck]
    work_shrink: torch.Tensor      # [B, F, HW]
    work_value: torch.Tensor       # [B, O, F, HW, Cv]
    work_obj_valid: torch.Tensor   # [O, F] bool
    work_sel: torch.Tensor         # [B, F, HW, Ck] selection (long-term mode)
    work_use: torch.Tensor         # [B, F, HW] usage counters
    work_life: torch.Tensor        # [B, F, HW]
    lt_key: torch.Tensor           # [B, L, Ck]
    lt_shrink: torch.Tensor        # [B, L]
    lt_value: torch.Tensor         # [B, O, L, Cv]
    lt_obj_valid: torch.Tensor     # [O, L] bool
    lt_use: torch.Tensor           # [B, L]
    lt_life: torch.Tensor          # [B, L]
    last_mask: torch.Tensor        # [B, O, H0, W0] previous frame's probabilities
    perm_n: int = 0                # permanent tokens used
    work_start: int = 0            # ring slot of the oldest frame
    work_count: int = 0            # frames in the ring
    lt_count: int = 0              # long-term tokens used

    @property
    def num_objects(self) -> int:
        return self.sensory.shape[1]

    def ring_valid(self) -> torch.Tensor:
        """[F] bool: which ring slots hold live frames."""
        f = self.work_key.shape[1]
        rel = (torch.arange(f, device=self.work_key.device) - self.work_start) % f
        return rel < self.work_count

    def lt_valid(self, offset: int = 0) -> torch.Tensor:
        """[L] bool: which long-term slots hold live tokens; the buffers
        hold the slots from global slot `offset` on (a rank's slice)."""
        return torch.arange(offset, offset + self.lt_key.shape[1],
                            device=self.lt_key.device) < self.lt_count


def init_state(*, batch: int, max_objects: int, h: int, w: int,
               sensory_dim: int, key_dim: int, value_dim: int,
               num_queries: int, embed_dim: int, perm_frames: int,
               work_frames: int, lt_capacity: int = 0,
               value_dtype: torch.dtype = torch.float32, device,
               lt_shard: Tuple[int, int] = (0, 1)) -> MemoryState:
    """An empty state; h, w are the stride-16 dims (HW = h*w tokens/frame),
    lt_capacity the long-term tokens (0 outside long-term mode), of which
    the long-term buffers hold the slice of lt_shard = (rank, D). The value
    stores hold value_dtype: bf16 under amp, where the mask encoder emits
    bf16 values and the read takes them as they are."""
    lt_capacity = _shard_size(lt_capacity, lt_shard)
    hw = h * w
    pcap = perm_frames * hw
    B, O = batch, max_objects

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MemoryState(
        sensory=z(B, O, sensory_dim, h, w),
        obj_v=z(B, O, num_queries, embed_dim + 1),
        perm_key=z(B, pcap, key_dim),
        perm_shrink=z(B, pcap),
        perm_value=z(B, O, pcap, value_dim, dtype=value_dtype),
        perm_obj_valid=z(O, pcap, dtype=torch.bool),
        work_key=z(B, work_frames, hw, key_dim),
        work_shrink=z(B, work_frames, hw),
        work_value=z(B, O, work_frames, hw, value_dim, dtype=value_dtype),
        work_obj_valid=z(O, work_frames, dtype=torch.bool),
        work_sel=z(B, work_frames, hw, key_dim),
        work_use=z(B, work_frames, hw),
        work_life=z(B, work_frames, hw),
        lt_key=z(B, lt_capacity, key_dim),
        lt_shrink=z(B, lt_capacity),
        lt_value=z(B, O, lt_capacity, value_dim, dtype=value_dtype),
        lt_obj_valid=z(O, lt_capacity, dtype=torch.bool),
        lt_use=z(B, lt_capacity),
        lt_life=z(B, lt_capacity),
        last_mask=z(B, O, h * 16, w * 16),
    )


def _shard_size(cap: int, lt_shard: Tuple[int, int]) -> int:
    if cap % lt_shard[1]:
        raise ValueError(f"long-term capacity {cap} does not divide across "
                         f"{lt_shard[1]} ranks")
    return cap // lt_shard[1]


LT_FIELDS = (("lt_key", 1), ("lt_shrink", 1), ("lt_value", 2),
             ("lt_obj_valid", 1), ("lt_use", 1), ("lt_life", 1))


def slice_lt(state: MemoryState, lt_shard: Tuple[int, int]) -> MemoryState:
    """The state with only lt_shard = (rank, D)'s slice of whole long-term
    buffers."""
    rank, d = lt_shard
    if d == 1:
        return state
    c = _shard_size(state.lt_key.shape[1], lt_shard)
    return dataclasses.replace(state, **{
        name: getattr(state, name).narrow(dim, rank * c, c).clone()
        for name, dim in LT_FIELDS})


def _grow(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if x.shape[dim] >= size:
        return x
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def pad_objects(state: MemoryState, new_max_objects: int) -> MemoryState:
    """Grow the padded object axis."""
    n = new_max_objects
    return dataclasses.replace(
        state,
        sensory=_grow(state.sensory, 1, n),
        obj_v=_grow(state.obj_v, 1, n),
        perm_value=_grow(state.perm_value, 1, n),
        perm_obj_valid=_grow(state.perm_obj_valid, 0, n),
        work_value=_grow(state.work_value, 1, n),
        work_obj_valid=_grow(state.work_obj_valid, 0, n),
        lt_value=_grow(state.lt_value, 1, n),
        lt_obj_valid=_grow(state.lt_obj_valid, 0, n),
        last_mask=_grow(state.last_mask, 1, n),
    )


def resize_work_ring(state: MemoryState, new_frames: int) -> MemoryState:
    """The working-memory ring reallocated to new_frames frame slots, its
    frames in FIFO order from slot 0 (cutie_tpu state.py:resize_work_ring,
    reference memory_manager.py:59-75). A shrink keeps the newest frames:
    the ones the reference's next FIFO sieve would keep."""
    f = state.work_key.shape[1]
    if new_frames == f:
        return state
    keep = min(state.work_count, new_frames)
    # chronological slot order, the newest `keep` kept
    src = [(state.work_start + i) % f for i in range(state.work_count)]
    src = src[state.work_count - keep:]
    idx = torch.tensor(src, dtype=torch.long, device=state.work_key.device)

    def take(x, dim):
        shape = list(x.shape)
        shape[dim] = new_frames
        out = x.new_zeros(shape)
        out.narrow(dim, 0, keep).copy_(x.index_select(dim, idx))
        return out

    return dataclasses.replace(
        state,
        work_key=take(state.work_key, 1),
        work_shrink=take(state.work_shrink, 1),
        work_sel=take(state.work_sel, 1),
        work_value=take(state.work_value, 2),
        work_obj_valid=take(state.work_obj_valid, 1),
        work_use=take(state.work_use, 1),
        work_life=take(state.work_life, 1),
        work_start=0, work_count=keep)


def resize_lt_capacity(state: MemoryState, new_cap: int,
                       lt_shard: Tuple[int, int] = (0, 1)) -> MemoryState:
    """The long-term buffers reallocated to new_cap tokens (cutie_tpu
    state.py:resize_lt_capacity): a grow appends invalid slots, a shrink
    keeps the first new_cap tokens. The state's buffers are whole; with
    lt_shard = (rank, D) the result keeps that rank's slice."""
    cap = state.lt_key.shape[1]
    if new_cap == cap:
        return slice_lt(state, lt_shard)

    def resize(x, dim):
        if new_cap < cap:
            return x.narrow(dim, 0, new_cap).clone()
        return _grow(x, dim, new_cap)

    return slice_lt(dataclasses.replace(
        state,
        lt_key=resize(state.lt_key, 1),
        lt_shrink=resize(state.lt_shrink, 1),
        lt_value=resize(state.lt_value, 2),
        lt_obj_valid=resize(state.lt_obj_valid, 1),
        lt_use=resize(state.lt_use, 1),
        lt_life=resize(state.lt_life, 1).clamp_(min=1e-7),
        lt_count=min(state.lt_count, new_cap)), lt_shard)


def grow_perm(state: MemoryState, new_perm_tokens: int) -> MemoryState:
    """Grow the permanent buffer capacity (repeated commits)."""
    n = new_perm_tokens
    return dataclasses.replace(
        state,
        perm_key=_grow(state.perm_key, 1, n),
        perm_shrink=_grow(state.perm_shrink, 1, n),
        perm_value=_grow(state.perm_value, 2, n),
        perm_obj_valid=_grow(state.perm_obj_valid, 1, n),
    )


def reorder_objects(state: MemoryState, idx: torch.Tensor,
                    keep: torch.Tensor) -> MemoryState:
    """Permute and compact the padded object axis after deletions: slot s
    takes old slot idx[s]; slots with keep[s] == 0 are zeroed."""
    def ob(x, dim):
        moved = x.index_select(dim, idx)
        shape = [1] * x.dim()
        shape[dim] = -1
        return moved * keep.view(shape).to(moved.dtype)

    return dataclasses.replace(
        state,
        sensory=ob(state.sensory, 1),
        obj_v=ob(state.obj_v, 1),
        perm_value=ob(state.perm_value, 1),
        perm_obj_valid=ob(state.perm_obj_valid, 0),
        work_value=ob(state.work_value, 1),
        work_obj_valid=ob(state.work_obj_valid, 0),
        lt_value=ob(state.lt_value, 1),
        lt_obj_valid=ob(state.lt_obj_valid, 0),
        last_mask=ob(state.last_mask, 1),
    )
