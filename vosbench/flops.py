"""Operations and bytes of a frame's work, counted from shapes.

The read kernel's work is counted from the query and valid-token counts of
the benchmark's own memory schedule (vosbench/schedule.py); the network's
from the frozen reference network run under torch's FlopCounterMode at the
cell's shapes (convolutions, matmuls and attention: two operations a
multiply-add). Neither asks the program what it dispatched.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
F32 = 4


def peaks(device_kind: str) -> Optional[dict]:
    """The data sheet's peaks of a card by its torch.cuda.get_device_name(),
    or None for a card the table does not hold."""
    return json.loads(PEAKS_FILE.read_text())["devices"].get(device_kind)


def read_ops(queries: int, valid: int, key_dim: int, top_k: int,
             objects: int, value_dim: int) -> int:
    """One read: the direct-form similarity, 4 operations (difference,
    weight, square, sum) a query, valid key and channel, and the readout,
    a multiply-add a query, kept key, object and value channel."""
    return (4 * queries * valid * key_dim
            + 2 * queries * min(top_k, valid) * objects * value_dim)


def read_bytes(queries: int, valid: int, key_dim: int, objects: int,
               value_dim: int, value_bytes: int = F32) -> int:
    """One read, each input byte read once and each output byte written
    once: the valid keys and shrinkage, the query keys and selection, every
    valid value row, the readout and the usage of the valid keys."""
    return (F32 * valid * (key_dim + 1) + F32 * 2 * queries * key_dim
            + value_bytes * objects * valid * value_dim
            + F32 * objects * queries * value_dim + F32 * valid)


def read_bound_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the operations at
    the fp32 peak (the read has no tensor-core path) and the bytes at the
    memory bandwidth."""
    return max(ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])


def consolidation_ops(candidates: int, prototypes: int, key_dim: int,
                      objects: int, value_dim: int) -> int:
    """One batch row's consolidation: the prototypes' direct-form
    similarity to the candidates, and the softmax-weighted shrinkage and
    values."""
    return (4 * prototypes * candidates * key_dim
            + 2 * prototypes * candidates * (1 + objects * value_dim))


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@torch.no_grad()
def stage_flops(net, batch: int, objects: int, hp: int, wp: int,
                device) -> Dict[str, int]:
    """Network operations of each stage of a frame at padded size hp x wp:
    encode (encode_image and transform_key), segment (pixel fusion, the
    object transformer and the decoder with its sensory update) and
    memorize (the mask encoder and the object summarizer). net is the
    reference network (vosbench.reference.network.CUTIE)."""
    mc = net.model_cfg
    h, w = hp // 16, wp // 16
    image = torch.rand((batch, 3, hp, wp), device=device)
    sensory = torch.zeros((batch, objects, mc.sensory_dim, h, w), device=device)
    masks = torch.rand((batch, objects, hp, wp), device=device)
    q = mc.object_transformer.num_queries
    obj_v = torch.rand((batch, objects, 1, q, mc.object_transformer.embed_dim + 1),
                       device=device)
    selector = torch.ones((batch, objects), device=device)
    feats = {}

    def encode():
        ms, pix = net.encode_image(image)
        feats.update(ms=ms, pix=pix, key=net.transform_key(ms[0]))

    out = {"encode": _count(encode)}
    readout = torch.rand((batch, objects, mc.value_dim, h, w), device=device)

    def segment():
        fused = net.pixel_fusion(feats["pix"], readout, sensory, masks)
        mem, _ = net.readout_query(fused, obj_v, selector=selector)
        net.segment(feats["ms"], mem, sensory, selector=selector,
                    update_sensory=True)

    out["segment"] = _count(segment)
    out["memorize"] = _count(lambda: net.encode_mask(
        image, feats["pix"], sensory, masks, deep_update=True))
    return out
