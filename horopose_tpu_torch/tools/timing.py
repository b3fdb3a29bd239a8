"""Time one kernel call on a CUDA card: on the device alone, and on the host.

`device_ms` launches the call back to back over a ring of distinct inputs
whose bytes together exceed twice the card's L2 cache, in the order they
were written, so no launch finds its input in L2, and reads two CUDA
events around the run. A ring is cut from one large tensor
(`ring_slices`). A sleep kernel
holds the stream while the host enqueues the launches, so the device runs
them without waiting for the host: the time is the kernels' own.
`host_ms` is the wrapper's host time: the call returns once its kernels
are enqueued.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Sequence

import torch

L2_BYTES = 50e6        # H100: 50 MB of L2
RING_BYTES = 2 * L2_BYTES
# the sleep kernel counts cycles; at most ~2 GHz, so it lasts at least this
# long per cycle
_NS_PER_CYCLE = 0.5
# launches a run, at most: the launch queue must hold them all while the
# stream sleeps
MAX_LAUNCHES = 200


def ring_size(bytes_each: int, total: float = RING_BYTES) -> int:
    """How many distinct inputs of `bytes_each` bytes exceed `total` bytes
    together (at least 2)."""
    return max(2, int(total // max(bytes_each, 1)) + 1)


def ring_slices(big, count: int) -> list:
    """`count` equal consecutive slices of `big` along its first axis; of a
    tuple of tensors, `count` tuples of their slices."""
    if isinstance(big, tuple):
        return list(zip(*(ring_slices(t, count) for t in big)))
    m = big.shape[0] // count
    return [big[i * m:(i + 1) * m] for i in range(count)]


def host_ms(fn: Callable, arg, reps: int = 20) -> float:
    """Median host time of fn(arg) in ms, the device idle before each call,
    after one warm-up."""
    fn(arg)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def device_ms(fn: Callable, inputs: Sequence,
              per_call_host_ms: float = 0.2) -> float:
    """Device time of one call fn(inputs[i]) in ms: twice as many calls as
    `inputs` (at least 20, at most MAX_LAUNCHES) through `inputs` in order,
    cycling, between two CUDA events, divided by their number. The stream
    sleeps while the host enqueues them (about per_call_host_ms each); if
    the sleep ran out before the last call was enqueued, the run is
    repeated with a sleep twice as long."""
    n = min(max(20, 2 * len(inputs)), MAX_LAUNCHES)
    for arg in inputs[-2:]:   # warm-up on the inputs the run reaches last
        fn(arg)
    sleep_ms = 1.0 + 2.0 * n * per_call_host_ms
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * 1e6 / _NS_PER_CYCLE))
        start.record()
        for i in range(n):
            fn(inputs[i % len(inputs)])
        enqueued_in_time = not start.query()   # the sleep still holds
        end.record()
        end.synchronize()
        if enqueued_in_time:
            return start.elapsed_time(end) / n
        sleep_ms *= 2
    raise RuntimeError("device_ms: the host could not enqueue the launches "
                       "within the sleep")
