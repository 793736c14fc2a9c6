"""Device-idle ms per step inside the program's mbe.shard.round ranges
(sharding): from the traced slice, each device's idle time while the one
host thread was inside a round, per round; the largest over the run's
devices, the card the host starves most, which a mean would hide. None
without a traced slice or without the span (a program older than it)."""

from portbench.metrics.program_spans import events_of, idle_in

SPAN = "mbe.shard.round"


def worst_ms(events, devices, steps):
    """The largest over `devices` (indices) of each one's idle ms per step
    inside SPAN ranges, from `events` (events_of's tuples), or None where
    a device has no such range to read."""
    values = [idle_in(events, SPAN, d) for d in devices]
    if not values or any(v is None for v in values):
        return None
    return max(1e-3 * v / steps for v in values)


def read(run):
    prof = getattr(run, "_prof_done", None)
    if prof is None or run.trace is None or not run.trace["steps"]:
        return None
    return worst_ms(events_of(prof), list(run.trace["devices"]), run.trace["steps"])
