"""Uploads ahead of use, shared by io/loader.PrefetchLoader and
pipeline/runner.run_sequence_streamed (the port of their jax.device_put
threads).

`upload_ahead(items, device, depth)` runs a background thread that takes
(key, array) items from an iterator and hands (key, tensor on device) to
the caller, at most `depth` items ahead of it. On a CUDA device the
thread copies each array into one of `depth + 1` pinned host buffers (a
ring) and from there to the card with copy_(non_blocking=True) on a side
stream of that device, inside torch.cuda.device(device), recording one
event per slot; it writes a slot again only after the slot's event has
completed. The caller's current stream waits on the event, and the
tensor is record_stream'ed to that stream, so the caching allocator does
not hand its memory to the side stream while the caller's work may
still read it. On the CPU the thread hands over plain tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

_END = object()
_POLL_S = 0.1  # how often a blocked producer looks for the consumer's stop


def _as_array(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _PinnedRing:
    """`slots` pinned host buffers, each with the event of its last copy
    to `device`, used in turn; a side stream of `device` for the copies."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers = [torch.empty(0, dtype=torch.uint8) for _ in range(slots)]
        self.events = [None] * slots
        self.next = 0

    def upload(self, arr: np.ndarray) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Copy `arr` to the device through the next slot; returns the
        device tensor and the event that marks the end of its copy."""
        s = self.next
        self.next = (s + 1) % len(self.buffers)
        if self.events[s] is not None:
            self.events[s].synchronize()  # the slot's last copy has read it
        arr = np.ascontiguousarray(arr)
        if self.buffers[s].numel() < arr.nbytes:
            self.buffers[s] = torch.empty(arr.nbytes, dtype=torch.uint8, pin_memory=True)
        host = self.buffers[s][:arr.nbytes].numpy().view(arr.dtype).reshape(arr.shape)
        np.copyto(host, arr)
        src = torch.from_numpy(host)
        with torch.cuda.stream(self.stream):
            dev = torch.empty(arr.shape, dtype=src.dtype, device=self.device)
            dev.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[s] = event
        return dev, event


def upload_ahead(items: Iterable[Tuple[Any, Any]], device: torch.device,
                 depth: int = 2) -> Iterator[Tuple[Any, Optional[torch.Tensor]]]:
    """(key, tensor on `device`) for each (key, array) of `items`, in
    order, uploaded by a background thread up to `depth` items ahead. An
    item whose array is None passes as None. An exception raised while
    iterating `items` is raised here. Leaving the loop early stops the
    thread at its next item; the thread closes `items` (a generator's
    clean-up runs there, where it was iterated)."""
    device = torch.device(device)
    depth = max(1, depth)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        it = iter(items)
        try:
            if device.type == "cuda":
                with torch.cuda.device(device):
                    ring = _PinnedRing(device, depth + 1)
                    for key, x in it:
                        up = None if x is None else ring.upload(_as_array(x))
                        if not put((key, up)):
                            return
            else:
                for key, x in it:
                    t = None if x is None else torch.from_numpy(np.array(_as_array(x)))
                    if not put((key, (t, None))):
                        return
            put(_END)
        except Exception as exc:  # handed to the consumer, raised there
            put(exc)
        finally:
            if hasattr(it, "close"):
                it.close()

    thread = threading.Thread(target=produce, daemon=True, name="upload_ahead")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            key, up = item
            if up is None:
                yield key, None
                continue
            t, event = up
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                t.record_stream(consumer)
            yield key, t
    finally:
        stop.set()
