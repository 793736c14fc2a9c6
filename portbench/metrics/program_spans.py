"""The program's host spans (mbe_tpu_torch/utils/spans.py), read two ways.

`mean_ms(name)`: the span's counters, which run whether or not a profiler
does, from the program's `profiling.snapshot()`: total ns over count, over
the whole run (set-up's warm-up included). The counters live in the
program's module, so they outlast the entry's `finish`.

`idle_in_ms(run, name)`: from the traced slice, the device-idle time that
falls inside the program's `name` ranges, per traced step, each device's
own, the mean over the run's devices. The harness's parsed trace keeps
only its own span names, and a profiler's trace can be exported once, so
this reads the stopped profiler's (`run._prof_done`) own events
(`events()`): the "slice" annotation, the program's ranges and the device
operations, all from that one source, on one clock.

Either reads None where the program has no such span (a program older
than its spans).
"""

from portbench.trace_reader import _union, mean_over_devices


def mean_ms(name):
    """Mean ms per entry of the program's span `name`, or None."""
    from mbe_tpu_torch.utils import profiling
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    count, ns = snapshot().get(name, (0, 0))
    return 1e-6 * ns / count if count else None


def _intersection_us(a, b):
    """Length of the intersection of two sorted lists of disjoint [s, e)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def events_of(prof):
    """(kind, name, start_us, end_us, device) of every event a stopped
    torch.profiler recorded (its `events()`, on one clock): kind "device"
    for an operation on a device (a kernel, copy or set), with the device's
    index, "host" for the rest, annotations included, with None. The
    devices' projections of host annotations carry their annotation's name
    and are left out."""
    from torch.autograd import DeviceType
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    out = []
    for e in events:
        if e.device_type == DeviceType.CPU:
            kind, device = "host", None
        elif e.name in host_names:
            continue
        else:
            kind, device = "device", e.device_index
        out.append((kind, e.name, float(e.time_range.start), float(e.time_range.end), device))
    return out


def idle_in(events, name, device):
    """Idle us of `device` (an index) inside `name` ranges over the "slice"
    annotation, from `events` (events_of's tuples), or None without such a
    range."""
    window, ops, ranges = None, [], []
    for kind, ev_name, start, end, ev_device in events:
        if kind == "device":
            if ev_device == device:
                ops.append((start, end))
        elif ev_name == "slice":
            window = (start, end)
        elif ev_name == name:
            ranges.append((start, end))
    if window is None or not ranges:
        return None
    lo, hi = window
    busy = _union([(max(s, lo), min(e, hi)) for s, e in ops if e > lo and s < hi])
    idle, t = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    inside = _union([(max(s, lo), min(e, hi)) for s, e in ranges if e > lo and s < hi])
    return _intersection_us(idle, inside)


def idle_in_ms(run, name):
    """Device-idle ms per traced step inside the program's `name` ranges,
    the mean over the run's devices, or None."""
    prof = getattr(run, "_prof_done", None)
    if prof is None or run.trace is None:
        return None
    events = events_of(prof)

    def one(_, device):
        us = idle_in(events, name, device["index"])
        return None if us is None else 1e-3 * us / run.trace["steps"]
    return mean_over_devices(run.trace, one)
