"""Spans: named ranges of the port's host code in a torch.profiler trace.

    with span("steps.segment"):
        ...

While a torch profiler runs in the process (torch.profiler.profile, or the
autograd profiler it drives), span(name) is a
torch.profiler.record_function range named "cutie." + name: a Kineto user
annotation on the host's timeline, on the device trace's clock, and every
launch made inside it carries the correlation id of the device operations
it issued, so a reader can put each operation down to the span that
launched it. There is no switch: any profiler around the port sees the
spans. With no profiler running, span returns one shared no-op context and
costs one flag check.

The host side of a frame is one thread, so spans nest strictly: a span's
parent is the innermost span that encloses it. One frame is one
"cutie.inference_core.step" span; below it sit inference_core.upload,
steps.encode (models.pixel_encoder, models.key_projection),
steps.segment (steps.read_memory with read_kernel.radix_topk_readout on
the card, models.pixel_fusion, models.object_transformer,
models.mask_decoder), inference_core.merge_mask, steps.memorize
(models.mask_encoder) and steps.consolidate; inference_core.to_host is
output_prob_to_mask, outside the step.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "cutie."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A record_function range "cutie.<name>" while a profiler runs (the
    flag torch.autograd.profiler._is_profiler_enabled, which
    torch.profiler.profile sets while it runs); else a shared no-op
    context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
