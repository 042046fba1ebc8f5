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
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MemoryState:
    sensory: torch.Tensor          # [B, O, Cs, h, w] fp32
    obj_v: torch.Tensor            # [B, O, Q, E+1] fp32
    perm_key: torch.Tensor         # [B, Pcap, Ck]
    perm_shrink: torch.Tensor      # [B, Pcap]
    perm_value: torch.Tensor       # [B, O, Pcap, Cv]
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

    def lt_valid(self) -> torch.Tensor:
        """[L] bool: which long-term slots hold live tokens."""
        return torch.arange(self.lt_key.shape[1],
                            device=self.lt_key.device) < self.lt_count


def init_state(*, batch: int, max_objects: int, h: int, w: int,
               sensory_dim: int, key_dim: int, value_dim: int,
               num_queries: int, embed_dim: int, perm_frames: int,
               work_frames: int, lt_capacity: int = 0, device) -> MemoryState:
    """An empty state; h, w are the stride-16 dims (HW = h*w tokens/frame),
    lt_capacity the long-term tokens (0 outside long-term mode)."""
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
        perm_value=z(B, O, pcap, value_dim),
        perm_obj_valid=z(O, pcap, dtype=torch.bool),
        work_key=z(B, work_frames, hw, key_dim),
        work_shrink=z(B, work_frames, hw),
        work_value=z(B, O, work_frames, hw, value_dim),
        work_obj_valid=z(O, work_frames, dtype=torch.bool),
        work_sel=z(B, work_frames, hw, key_dim),
        work_use=z(B, work_frames, hw),
        work_life=z(B, work_frames, hw),
        lt_key=z(B, lt_capacity, key_dim),
        lt_shrink=z(B, lt_capacity),
        lt_value=z(B, O, lt_capacity, value_dim),
        lt_obj_valid=z(O, lt_capacity, dtype=torch.bool),
        lt_use=z(B, lt_capacity),
        lt_life=z(B, lt_capacity),
        last_mask=z(B, O, h * 16, w * 16),
    )


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
