"""Host-to-device staging of loader batches, ahead of the step.

Port of the single-device part of
`horopose_tpu/parallel/mesh.py::prefetch_to_device`: a batch's copy to the
card is issued `size` batches before the step reads it, so the copy
overlaps the steps before it instead of running at the step's start. On a
CUDA device the copies are non_blocking on a side stream, one event per
batch; when the step takes a batch, the current stream waits for that
batch's event, and each of its tensors is marked as used by the current
stream (`record_stream`), so the caching allocator does not hand its memory
back to the side stream while the step may still read it. The loader's
pinned source tensors are held until their batch is handed over; PyTorch's
pinned-memory allocator itself keeps a block from reuse until the copy
that reads it has run. size=0 copies each batch on the current stream when
the step takes it. On the CPU the batches are taken `size` ahead as well,
with no stream.
The mesh and multi-host parts wait for the port's data parallelism.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Iterator, List, Mapping

import torch


def to_device(batch: Mapping, device, non_blocking: bool = False) -> Dict:
    """A nested dict of tensors on `device`."""
    return {k: to_device(v, device, non_blocking) if isinstance(v, Mapping)
            else v.to(device, non_blocking=non_blocking)
            for k, v in batch.items()}


def batch_tensors(batch: Mapping) -> List[torch.Tensor]:
    """The tensors of a nested dict batch."""
    out = []
    for v in batch.values():
        out.extend(batch_tensors(v) if isinstance(v, Mapping) else [v])
    return out


def prefetch_to_device(batches: Iterable[Mapping], device, size: int = 2
                       ) -> Iterator[Dict]:
    """Yield the batches of `batches` on `device`, each taken from
    `batches` and copied `size` batches ahead of the consumer (see the
    module docstring)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if not size:
        for b in batches:
            yield to_device(b, device, non_blocking=cuda)
        return
    side = torch.cuda.Stream(device) if cuda else None
    queue = deque()
    for host in batches:
        queue.append(_stage(host, device, side))
        if len(queue) > size:
            yield _hand_over(queue.popleft(), device)
    while queue:
        yield _hand_over(queue.popleft(), device)


def _stage(host: Mapping, device, side):
    """(host batch, its copy on the device, the copy's event on the side
    stream); no stream or event off CUDA."""
    if side is None:
        return host, to_device(host, device), None
    with torch.cuda.stream(side):
        staged = to_device(host, device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return host, staged, done


def _hand_over(item, device) -> Dict:
    _, staged, done = item
    if done is None:
        return staged
    current = torch.cuda.current_stream(device)
    current.wait_event(done)
    for t in batch_tensors(staged):
        t.record_stream(current)
    return staged
