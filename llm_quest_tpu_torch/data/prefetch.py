"""Host→device input pipeline (counterpart of ``llm_quest_tpu/data/prefetch.py``).

While the card runs step N, batch N+1 is already being copied: a daemon
thread turns each host batch into pinned tensors and starts their copies
with ``non_blocking=True`` on a side CUDA stream, recording an event; the
consumer makes its current stream wait on that event before it uses the
batch, and marks the tensors as used on its stream so the allocator does not
hand their memory back early. On a CPU device the batches are only converted.
"""

import queue
import threading

import numpy as np
import torch

from llm_quest_tpu_torch.config import resolve_device


def _host_tensor(x, pin):
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.pin_memory() if pin and not t.is_pinned() else t


def prefetch_to_device(iterator, size=2, device=None):
    """Yield the dict batches of ``iterator`` as tensors on ``device``
    (default: the current CUDA device; raises without one, see
    ``config.resolve_device``), with up to ``size`` batches converted and in
    flight ahead of the consumer. An exception in the iterator or a copy is
    re-raised at the consumer's next pull."""
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_cuda else None
    q = queue.Queue(maxsize=size)
    end = object()

    def produce():
        try:
            for batch in iterator:
                host = {k: _host_tensor(v, on_cuda) for k, v in batch.items()}
                if on_cuda:
                    with torch.cuda.stream(side):
                        item = {k: t.to(device, non_blocking=True) for k, t in host.items()}
                        ready = torch.cuda.Event()
                        ready.record(side)
                    q.put((item, ready))
                else:
                    q.put((host, None))
            q.put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            q.put(e)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        batch, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for t in batch.values():
                t.record_stream(current)
        yield batch
