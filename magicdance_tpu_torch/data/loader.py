"""Host-side prefetching loader: worker threads, pinned host tensors,
asynchronous copies to the device.

Counterpart of `magicdance_tpu.data.loader.PrefetchLoader`: `workers`
producer threads each call `next` on an iterator of numpy batches of their
own; a transfer thread takes their batches in turn (worker 0, 1, ..., 0:
the same order on every run and every rank), turns each into tensors -- in
pinned host memory when the device is a GPU -- and starts
`.to(device, non_blocking=True)` on a side stream, so host decode and the
copy overlap the device's work; the consumer waits for that copy on its
current stream. `close()` stops and joins every thread.

With a `mesh`, every rank reads the same stream of global batches and keeps
its rows of each array (`parallel.mesh.batch_sharding`: the leading axis
split over 'data'), as JAX's `device_put` with a batch sharding lays out a
global batch. The device defaults to the card (the rank's card under a
process group).
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Callable, Iterator, Union

import numpy as np
import torch
import torch.distributed as dist

from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.parallel.mesh import batch_sharding
from magicdance_tpu_torch.parallel.multihost import local_device

_END = "__end__"  # a producer's iterator is exhausted


class PrefetchLoader:
    def __init__(
        self,
        batch_iter_factory: Callable[[int], Iterator[dict]],
        workers: int = 2,
        host_depth: int = 4,
        device_depth: int = 2,
        device: Union[str, torch.device, None] = None,
        mesh=None,
    ):
        if device is None:
            device = local_device() if dist.is_initialized() else "cuda"
        self.device = resolve_device(device)
        self.axis = batch_sharding(mesh)
        per_worker = max(1, -(-host_depth // workers))
        self._host_qs: "list[queue.Queue[dict]]" = [queue.Queue(maxsize=per_worker)
                                                    for _ in range(workers)]
        self._dev_q: "queue.Queue[dict]" = queue.Queue(maxsize=device_depth)
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._threads = []
        for w in range(workers):
            t = threading.Thread(target=self._produce, args=(w, batch_iter_factory(w)),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._transfer, daemon=True)
        t.start()
        self._threads.append(t)

    def _put_until_stop(self, q: "queue.Queue[dict]", item: dict) -> bool:
        """Blocking put that gives up when close() is called, so that no
        thread outlives close() blocked on a full queue."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, w: int, it: Iterator[dict]) -> None:
        q = self._host_qs[w]
        try:
            for batch in it:
                if self._stop.is_set() or not self._put_until_stop(q, batch):
                    return
            self._put_until_stop(q, {_END: True})
        except Exception as e:  # surfaces on the consumer side
            self._put_until_stop(q, {"__error__": repr(e)})

    def _rows(self, v):
        """This rank's rows of a global-batch array (all of it without a
        mesh)."""
        n = v.shape[0]
        if n % self.axis.size:
            raise ValueError(f"a global batch of {n} rows does not split over "
                             f"{self.axis.size} ranks")
        start, stop = self.axis.rows(n)
        return v[start:stop]

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(self._rows(v)))
            if self._stream is not None:
                t = t.pin_memory()
                with torch.cuda.stream(self._stream):
                    t = t.to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[k] = t
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
            out["__ready__"] = event
        return out

    def _transfer(self) -> None:
        try:
            active, turn = list(range(len(self._host_qs))), 0
            while not self._stop.is_set():
                if not active:
                    self._put_until_stop(self._dev_q, {_END: True})
                    return
                try:
                    batch = self._host_qs[active[turn]].get(timeout=0.2)
                except queue.Empty:
                    continue
                if _END in batch:
                    active.pop(turn)
                    turn = turn % len(active) if active else 0
                    continue
                turn = (turn + 1) % len(active)
                if "__error__" in batch:
                    self._put_until_stop(self._dev_q, batch)
                    return
                if not self._put_until_stop(self._dev_q, self._to_device(batch)):
                    return
        except Exception as e:  # surface on the consumer side, never hang
            self._put_until_stop(self._dev_q, {"__error__": repr(e)})

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self._dev_q.get()
        if _END in batch:
            self._put_until_stop(self._dev_q, batch)  # every later call ends too
            raise StopIteration
        if "__error__" in batch:
            raise RuntimeError(f"data worker failed: {batch['__error__']}")
        event = batch.pop("__ready__", None)
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
            for t in batch.values():  # the copy's memory is used on this stream
                t.record_stream(torch.cuda.current_stream(self.device))
        return batch

    def close(self, timeout: float = 5.0) -> None:
        """Stop every worker and transfer thread and join them. Safe to call
        more than once."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
            if t.is_alive():  # pragma: no cover - requires a wedged copy
                warnings.warn(f"PrefetchLoader thread {t.name} survived close()",
                              RuntimeWarning)
        for q in (*self._host_qs, self._dev_q):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
