"""Host batches: collates, a threaded loader, a pinned-memory prefetch.

Port of ``videotransformer_tpu/data/pipeline.py``:

- the collates (pipeline.py:23-60): ``collate_raw`` (uint8 clips for the
  device augment), ``collate_supervised``, ``collate_mim_raw`` and
  ``collate_mim``;
- ``Loader`` (pipeline.py:65-193): worker threads read the dataset (decode
  releases the interpreter lock), batches come out in order; a worker's
  exception is raised in the consumer, and so is the loss of every worker
  and a batch that makes no progress for ``worker_timeout`` seconds; under
  data parallelism each data rank (``process_index`` of ``num_processes``)
  reads its shard of the indices, the contiguous stride of
  pipeline.py:97-98;
- ``device_prefetch`` (pipeline.py:195-223): batches on their way to a CUDA
  device go through a ring of two pinned host buffers, each copied with
  ``non_blocking`` on a side stream while the previous batch computes; the
  consuming stream waits on the copy's event, and a pinned buffer is
  written again only after its last copy's event has completed. On a CPU
  device it is a plain ``.to``.
"""

import queue
import threading
import time

import numpy as np
import torch

from videotransformer_tpu_torch.data.mask_generator import pad_cube_marker
from videotransformer_tpu_torch.utils import profiling


def collate_raw(samples):
    """(clip uint8 (T, H, W, C), label) samples -> {"raw_video" (B, T, H,
    W, C) uint8, "label" (B,) int32}."""
    videos = np.stack([s[0] for s in samples])
    labels = np.asarray([s[1] for s in samples], dtype=np.int32)
    return {"raw_video": videos, "label": labels}


def collate_supervised(samples):
    videos = np.stack([s[0] for s in samples]).astype(np.float32)
    labels = np.asarray([s[1] for s in samples], dtype=np.int32)
    return {"video": videos, "label": labels}


def collate_mim_raw(samples, max_cubes=8):
    """(clip uint8, mask, cube_marker) samples -> {"raw_video", "mask",
    "cube_marker" (B, max_cubes, 2), "cube_count"}: one uint8 clip a sample,
    augmented and normalised in the train step."""
    videos = np.stack([s[0] for s in samples])
    masks = np.stack([s[1] for s in samples]).astype(np.int32)
    markers, counts = pad_cube_marker([s[2] for s in samples], max_cubes)
    return {"raw_video": videos, "mask": masks,
            "cube_marker": markers, "cube_count": counts}


def collate_mim(samples, max_cubes=8):
    """(video, target, mask, cube_marker) samples -> a mim batch. The target
    is host HOG (T, h, w, 108) -> "hog", or the clip before Normalize (T, C,
    H, W) -> "raw" (told apart by C = 3 at axis 2 of the batch)."""
    videos = np.stack([s[0] for s in samples]).astype(np.float32)
    second = np.stack([s[1] for s in samples]).astype(np.float32)
    masks = np.stack([s[2] for s in samples]).astype(np.int32)
    markers, counts = pad_cube_marker([s[3] for s in samples], max_cubes)
    key = "raw" if second.ndim == 5 and second.shape[2] == 3 else "hog"
    return {"video": videos, key: second, "mask": masks,
            "cube_marker": markers, "cube_count": counts}


class Loader:
    """Iterable over collated numpy batches, read by worker threads.

    ``shuffle`` permutes the indices with ``seed + epoch`` (``set_epoch``),
    the same permutation in every process; process ``process_index`` of
    ``num_processes`` then reads indices ``process_index::num_processes``
    of it (JAX pipeline.py:97-98). ``drop_last`` drops a short last batch,
    and across processes also the batches past the shortest shard's last
    full one, so that every data rank takes the same number of steps (a
    shard one sample longer than another could otherwise give its rank one
    more step than the gradient all-reduce of the others: the JAX Loader
    keeps it)."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 num_workers=2, collate_fn=collate_supervised, seed=0,
                 worker_timeout=300.0, process_index=0, num_processes=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.collate_fn = collate_fn
        self.seed = seed
        self.epoch = 0
        if not 0 <= process_index < num_processes:
            raise ValueError(f"process_index {process_index} of "
                             f"{num_processes} processes")
        self.process_index = process_index
        self.num_processes = num_processes
        # seconds one batch may go without a sample arriving before the
        # consumer raises
        self.worker_timeout = worker_timeout

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        idx = idx[self.process_index::self.num_processes]
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = batches[:len(self)]
        return batches

    def __len__(self):
        n, p = len(self.dataset), self.num_processes
        if self.drop_last:  # the shortest shard's, the last process's
            return len(range(p - 1, n, p)) // self.batch_size
        return -(-len(range(self.process_index, n, p)) // self.batch_size)

    def __iter__(self):
        batches = self._batches()
        if not batches:
            return
        sample_q = queue.Queue(maxsize=self.num_workers * 4)
        out = {}  # batch index -> {position: sample}
        cond = threading.Condition()
        stop = threading.Event()
        errors = []
        running = [self.num_workers]  # workers that have not returned

        def work():
            while not stop.is_set():
                try:
                    item = sample_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is None:
                    return
                bi, si, ds_index = item
                try:
                    sample = self.dataset[ds_index]
                except Exception as exc:  # raised again in the consumer
                    with cond:
                        errors.append((ds_index, exc))
                    return
                with cond:
                    out.setdefault(bi, {})[si] = sample
                    cond.notify_all()

        def worker():
            try:
                work()
            finally:  # the consumer looks again at errors and workers
                with cond:
                    running[0] -= 1
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def feeder():
            for bi, batch in enumerate(batches):
                for si, ds_index in enumerate(batch):
                    while not stop.is_set():
                        try:
                            sample_q.put((bi, si, int(ds_index)), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            for _ in threads:
                sample_q.put(None)

        threading.Thread(target=feeder, daemon=True).start()
        poll = min(5.0, self.worker_timeout)
        try:
            for bi, batch in enumerate(batches):
                with cond:
                    deadline = time.monotonic() + self.worker_timeout
                    while len(out.get(bi, {})) < len(batch):
                        if errors:
                            ds_index, exc = errors[0]
                            raise RuntimeError(
                                f"loader worker failed on dataset index "
                                f"{ds_index}") from exc
                        if not running[0]:
                            raise RuntimeError(
                                "all loader workers exited before batch "
                                f"{bi} was complete")
                        got = len(out.get(bi, {}))
                        cond.wait(timeout=poll)
                        if len(out.get(bi, {})) > got:
                            deadline = time.monotonic() + self.worker_timeout
                        elif time.monotonic() > deadline:
                            raise TimeoutError(
                                f"loader made no progress on batch {bi} for "
                                f"{self.worker_timeout:g}s ({got}/"
                                f"{len(batch)} samples ready)")
                    ready = out.pop(bi)
                yield self.collate_fn([ready[i] for i in range(len(batch))])
        finally:
            stop.set()


def _host(v):
    """A batch value as a CPU tensor (numpy arrays are not copied)."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


class _PinnedRing:
    """Two sets of pinned host buffers, one per batch in flight; a set is
    written only after the event of the copy that last read it has
    completed."""

    def __init__(self):
        self.buffers = [{}, {}]
        self.events = [None, None]
        self.turn = 0

    def stage(self, batch):
        """Write ``batch`` into the next buffer set -> (slot, pinned)."""
        slot, self.turn = self.turn, 1 - self.turn
        if self.events[slot] is not None:
            with profiling.span("prefetch.event_wait"):
                self.events[slot].synchronize()
        bufs = self.buffers[slot]
        pinned = {}
        with profiling.span("prefetch.stage"):
            for k, v in batch.items():
                src = _host(v)
                buf = bufs.get(k)
                if buf is None or buf.shape != src.shape or \
                        buf.dtype != src.dtype:
                    buf = bufs[k] = torch.empty(src.shape, dtype=src.dtype,
                                                pin_memory=True)
                buf.copy_(src)
                pinned[k] = buf
        return slot, pinned


def device_prefetch(iterator, device, stream=None):
    """Yield each batch (a dict of numpy arrays or tensors) of ``iterator``
    as tensors on ``device``, the next one copying while the current one is
    in use. On a CUDA device the copies run on ``stream`` (a new side
    stream by default) from a ring of two pinned buffers; the batch handed
    out is ready for the current stream.

    While a profiler session is active each batch handed out records
    ``prefetch.next`` (the generator's work for it, the consumer's time
    between batches left out) with, on a card, the children
    ``prefetch.event_wait`` (the ring's wait for the copy that last read a
    buffer set) and ``prefetch.stage`` (the host copy into the pinned
    ring)."""
    device = torch.device(device)
    if device.type != "cuda":
        it = iter(iterator)
        while True:
            with profiling.span("prefetch.next"):
                batch = next(it, None)
                if batch is not None:
                    batch = {k: _host(v).to(device) for k, v in batch.items()}
            if batch is None:
                return
            yield batch
    stream = stream or torch.cuda.Stream(device)
    ring = _PinnedRing()

    def put(batch):
        slot, pinned = ring.stage(batch)
        with torch.cuda.stream(stream):
            on_device = {k: v.to(device, non_blocking=True)
                         for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(stream)
        ring.events[slot] = event
        return on_device, event

    it = iter(iterator)
    nxt = next(it, None)
    pending = None if nxt is None else put(nxt)
    while pending is not None:
        with profiling.span("prefetch.next"):
            nxt = next(it, None)
            ahead = None if nxt is None else put(nxt)
            batch, event = pending
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for v in batch.values():
                v.record_stream(current)
        yield batch
        pending = ahead
