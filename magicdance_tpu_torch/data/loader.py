"""Host-side prefetching loader: worker threads, pinned host tensors,
asynchronous copies to the device.

Counterpart of `magicdance_tpu.data.loader.PrefetchLoader`: `workers`
producer threads each call `next` on an iterator of numpy batches of their
own; a transfer thread turns each batch into tensors -- in pinned host memory
when the device is a GPU -- and starts `.to(device, non_blocking=True)` on a
side stream, so host decode and the copy overlap the device's work; the
consumer waits for that copy on its current stream. `close()` stops and joins
every thread.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Callable, Iterator, Union

import numpy as np
import torch


class PrefetchLoader:
    def __init__(
        self,
        batch_iter_factory: Callable[[int], Iterator[dict]],
        workers: int = 2,
        host_depth: int = 4,
        device_depth: int = 2,
        device: Union[str, torch.device] = "cpu",
    ):
        self.device = torch.device(device)
        self._host_q: "queue.Queue[dict]" = queue.Queue(maxsize=host_depth)
        self._dev_q: "queue.Queue[dict]" = queue.Queue(maxsize=device_depth)
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._threads = []
        for w in range(workers):
            t = threading.Thread(target=self._produce, args=(batch_iter_factory(w),),
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

    def _produce(self, it: Iterator[dict]) -> None:
        try:
            for batch in it:
                if self._stop.is_set() or not self._put_until_stop(self._host_q, batch):
                    return
        except Exception as e:  # surfaces on the consumer side
            self._put_until_stop(self._host_q, {"__error__": repr(e)})

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
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
            while not self._stop.is_set():
                try:
                    batch = self._host_q.get(timeout=0.2)
                except queue.Empty:
                    continue
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
        for q in (self._host_q, self._dev_q):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
