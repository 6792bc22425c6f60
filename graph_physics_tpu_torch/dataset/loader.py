"""Bucketed batching loader with background prefetch.

Counterpart of graph_physics_tpu/dataset/loader.py:BatchLoader (:34). A
batch holds frames of one static-shape bucket (stacked ``[B, N, F]``), or
with ``packed`` the frames of one trajectory (``[N, B, F]``). The batch
schedule comes from ``np.random.default_rng(seed)`` exactly as JAX draws
it, so both packages visit the same samples in the same order. A thread
builds the batches ahead of the consumer; with ``workers > 1`` a thread
pool builds the frames of a batch.

On a CUDA device each numpy leaf is copied into pinned host memory and
from there to the card with ``non_blocking=True``, on a side stream of the
loader; an event recorded after the copies is waited on by the consumer's
stream before the batch is handed out, and each tensor is marked as used on
that stream (``record_stream``), so the caching allocator does not give its
memory to the next batch while a step still reads it. A pinned buffer is
never refilled: each copy takes a fresh one from PyTorch's caching host
allocator, which keeps a block from reuse until the copy that read it has
finished. Multi-device sharding (``sharding``, ``process_shard``) is
ROADMAP A 9.
"""

from __future__ import annotations

import queue
import threading
from collections import defaultdict
from typing import Iterator, List, Optional

import numpy as np
import torch

from graph_physics_tpu_torch.core.graph import MeshGraph, contiguous
from graph_physics_tpu_torch.training import packed as packed_lib

SHARDING = "sharded loading is not ported (ROADMAP A 9)"


def stack_batch(frames: List[MeshGraph]) -> MeshGraph:
    """Stack same-bucket frames along a new leading batch axis
    (loader.py:stack_batch)."""
    return packed_lib.stack(frames)


class BatchLoader:
    """Iterate (shuffled) same-bucket batches of padded MeshGraphs."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, prefetch: int = 2, device_put: bool = True,
                 sharding=None, packed: bool = False, frame_transform=None,
                 process_shard: Optional[tuple] = None, workers: int = 1,
                 broadcast_static: bool = False, packed_transform=None, device="cuda"):
        """``device_put``: deliver torch tensors on ``device`` (host numpy
        batches otherwise). ``frame_transform``: a per-frame host hook
        applied before batching (the fused layout conversion);
        ``packed_transform`` its half-packed twin, which enables the
        vectorized lane (``_packed_fast``) when a frame transform is set.
        ``broadcast_static``: shared static leaves as [E, 1, F] views."""
        if sharding is not None or process_shard is not None:
            raise NotImplementedError(SHARDING)
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device_put = device_put
        self.device = torch.device(device)
        self.packed = packed
        self.frame_transform = frame_transform
        self.packed_transform = packed_transform
        self.workers = workers
        self.broadcast_static = bool(broadcast_static and packed)
        self._rng = np.random.default_rng(seed)
        self._executor = None
        self._stream = None

    def _batched_indices(self, shuffle: Optional[bool] = None) -> List[List[int]]:
        """loader.py:_batched_indices (:115): group by bucket (packed: by
        trajectory), shuffle each group, cut it into batches (a short last
        batch is repeat-padded), shuffle the batch order."""
        shuffle = self.shuffle if shuffle is None else shuffle
        by_bucket = defaultdict(list)
        for i in range(len(self.ds)):
            if self.packed:
                t, _, part = self.ds.indices_for(i)
                key = (t, part)
            else:
                key = self.ds.bucket_of(i)
            by_bucket[key].append(i)
        batches = []
        for idxs in by_bucket.values():
            idxs = np.asarray(idxs)
            if shuffle:
                self._rng.shuffle(idxs)
            for s in range(0, len(idxs), self.batch_size):
                chunk = idxs[s:s + self.batch_size].tolist()
                if len(chunk) < self.batch_size:
                    if self.drop_last:
                        continue
                    chunk = (chunk * self.batch_size)[:self.batch_size]
                batches.append(chunk)
        if shuffle:
            order = self._rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def __len__(self):
        return len(self._batched_indices(shuffle=False))

    def _build_one(self, i):
        f = self.ds[i]
        if self.frame_transform is not None:
            f = self.frame_transform(f)
        return f

    def _packed_fast(self, chunk) -> Optional[MeshGraph]:
        """The vectorized whole-batch lane (loader.py:_packed_fast :196):
        one ``get_frames_packed`` build and the template layout transform,
        or None, and the caller builds frame by frame (which warms this
        lane: the first batch of a trajectory makes the skeleton and the
        layout template)."""
        if not hasattr(self.ds, "get_frames_packed"):
            return None
        if self.frame_transform is not None and self.packed_transform is None:
            return None
        g = self.ds.get_frames_packed(chunk, train=True)
        if g is None:
            return None
        if self.packed_transform is not None:
            g = self.packed_transform(g)
            if g is None:
                return None
        return packed_lib.finalize_packed(g, len(chunk), self.broadcast_static)

    def host_batch(self, chunk) -> MeshGraph:
        """The numpy batch of sample ids ``chunk``: the vectorized lane
        when it applies, else frame by frame."""
        batch = self._packed_fast(chunk) if self.packed else None
        if batch is not None:
            return batch
        if self.workers > 1 and len(chunk) > 1:
            frames = list(self._pool().map(self._build_one, chunk))
        else:
            frames = [self._build_one(i) for i in chunk]
        if self.packed:
            return packed_lib.pack_frames(frames, broadcast_static=self.broadcast_static)
        return stack_batch(frames)

    def _pool(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=self.workers)
        return self._executor

    def _to_device(self, batch: MeshGraph):
        """(device batch, event or None): on a card, pinned copies on the
        loader's stream and the event recorded after them."""
        if self.device.type != "cuda":
            return MeshGraph.from_numpy(batch, self.device), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)

        def put(a, dtype):
            host = torch.from_numpy(contiguous(a)).to(dtype)
            return host.pin_memory().to(self.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            g = MeshGraph.from_numpy(batch, self.device, put=put)
            event = torch.cuda.Event()
            event.record(self._stream)
        return g, event

    def _produce(self, batches, q, stop: threading.Event):
        try:
            for chunk in batches:
                if stop.is_set():
                    return
                batch = self.host_batch(chunk)
                item = self._to_device(batch) if self.device_put else (batch, None)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaced to the consumer
            q.put(e)
        finally:
            q.put(None)

    def _deliver(self, item) -> MeshGraph:
        g, event = item
        if event is None:
            return g
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for name in MeshGraph.__dataclass_fields__:
            t = getattr(g, name)
            if isinstance(t, torch.Tensor):
                t.record_stream(stream)
        return g

    def __iter__(self) -> Iterator[MeshGraph]:
        batches = self._batched_indices()
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(batches, q, stop), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield self._deliver(item)
        finally:
            stop.set()
            while t.is_alive():  # let the producer see the flag and leave
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
