"""Deterministic sharded training loader.

The port's counterpart of cutie_tpu/data/loader.py (reference
cutie/dataset/setup_training_data.py:18-87 DistributedSampler + DataLoader
workers): a deterministic global index stream (a seeded permutation per
epoch) sharded by process rank, decoded by a thread pool ahead of the
training step. Resumption is exact: the stream position is a function of
(seed, epoch, iteration), and train.py fast-forwards epoch =
it // batches_per_epoch() on a checkpoint resume. Decoding runs in native
code that releases the GIL (the JPEG decoder, numpy), so threads overlap.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue
from typing import Dict, Iterator

import numpy as np


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into a batch: frames [B, T, 3, H, W] float32
    (the layout training/trainer.py takes), first_frame_gt [B, O, H, W],
    selector [B, O], cls_gt uint8 [B, T, H, W] (the loss one-hot encodes
    it at the sampled points on the device) and the samples' info."""
    return {
        "frames": np.stack([s["rgb"] for s in samples]),
        "first_frame_gt": np.stack([s["first_frame_gt"] for s in samples]),
        "selector": np.stack([s["selector"] for s in samples]),
        "cls_gt": np.stack([s["cls_gt"] for s in samples]).astype(np.uint8),
        "info": [s["info"] for s in samples],
    }


class ShardedLoader:
    """Iterates batches. The global batch is split across processes; each
    sample is decoded with a per-(epoch, index) RNG, so that the stream is
    reproducible and resumable."""

    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 num_workers: int = 8, process_index: int = 0,
                 process_count: int = 1, prefetch_batches: int = 2):
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} does not divide across "
                             f"{process_count} processes")
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.seed = seed
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch_batches = prefetch_batches

    def batches_per_epoch(self) -> int:
        return len(self.dataset) // self.global_batch

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(len(self.dataset))
        n_batches = self.batches_per_epoch()
        if n_batches == 0:
            raise ValueError(
                f"dataset of {len(self.dataset)} samples is smaller than the "
                f"global batch ({self.global_batch}): no full batch per epoch")

        def load_one(global_idx: int, sample_idx: int):
            sample_rng = np.random.default_rng((self.seed, epoch, int(sample_idx)))
            return self.dataset.get(int(global_idx), sample_rng)

        pool = ThreadPoolExecutor(max_workers=max(self.num_workers, 1))
        # backpressure: at most prefetch_batches batches submitted ahead of
        # the consumer, so that an abandoned iterator (a curriculum rebuild,
        # the end of a stage) leaves little work in flight
        pending = Queue(maxsize=max(self.prefetch_batches, 1))
        stop = threading.Event()

        def submit_all():
            for b in range(n_batches):
                if stop.is_set():
                    return
                start = b * self.global_batch + self.process_index * self.local_batch
                futs = [pool.submit(load_one, perm[start + i], start + i)
                        for i in range(self.local_batch)]
                while not stop.is_set():
                    try:
                        pending.put(futs, timeout=0.2)
                        break
                    except Full:
                        continue
                if stop.is_set():
                    return
            pending.put(None)

        t = threading.Thread(target=submit_all, daemon=True)
        t.start()
        try:
            while True:
                futs = pending.get()
                if futs is None:
                    break
                yield collate([f.result() for f in futs])
        finally:
            stop.set()
            # unblock the submitter if it waits on a full queue, cancel what
            # has not started and return without waiting for the samples in
            # flight: their threads finish them and exit
            try:
                while True:
                    pending.get_nowait()
            except Empty:
                pass
            t.join(timeout=5)
            pool.shutdown(wait=False, cancel_futures=True)
