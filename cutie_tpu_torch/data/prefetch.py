"""Host-side threaded frame prefetcher (the port's copy of
cutie_tpu/data/prefetch.py).

Replaces the reference's per-video DataLoader(num_workers=4)
(cutie/eval_vos.py:90): a bounded thread pool decodes JPEG/PNG ahead of the
device step. zlib and Pillow's JPEG decoder release the GIL, so threads
overlap with the step's launches.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator


def prefetch_iter(dataset, num_workers: int = 4, depth: int = 8) -> Iterator:
    """Yields dataset[i] in order with up to `depth` decoded frames in
    flight."""
    n = len(dataset)
    if n == 0:
        return

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = {}
        next_submit = 0

        def top_up():
            nonlocal next_submit
            while next_submit < n and len(futures) < depth:
                futures[next_submit] = pool.submit(dataset.__getitem__, next_submit)
                next_submit += 1

        top_up()
        for i in range(n):
            fut = futures.pop(i)
            top_up()
            yield fut.result()
