"""Host spans with counters (re-exported by utils/profiling.py).

`span(name)` times its block on the host whether or not a profiler runs:
it adds 1 to name's count and the block's `time.perf_counter_ns()` to its
total, module-level like the kernels' `LAUNCHES`. While torch.profiler
records, it also opens `torch.profiler.record_function(name)`, a range in
the same trace as the device's ops and on its clock. `snapshot()` reads
the totals.

The program's spans:

    mbe.graph.replay      graphs.Captured.replay: the host's cudaGraphLaunch
    mbe.stream.stage      StreamingDecoder: host unpack (when on), the copy
                          into the pinned slot and the upload's enqueue
    mbe.stream.wait       StreamingDecoder: waiting for a tick's readback
    mbe.stream.copy_out   StreamingDecoder: the copy out of the pinned slot
                          and the unbundle
    mbe.shard.round       parallel/sharding: one frame copied in and replayed
                          on every shard, each on its stream, with its PCM and
                          result words' copies out enqueued
"""

import contextlib
import time

import torch

_TOTALS = {}  # name -> [count, ns]


@contextlib.contextmanager
def span(name: str):
    """Count and time the block under `name`; a profiler range while one
    records."""
    t0 = time.perf_counter_ns()
    try:
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        total = _TOTALS.setdefault(name, [0, 0])
        total[0] += 1
        total[1] += time.perf_counter_ns() - t0


def snapshot() -> dict:
    """name -> (count, total ns) of every span entered so far."""
    return {name: (count, ns) for name, (count, ns) in _TOTALS.items()}
