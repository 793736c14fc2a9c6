"""Device-busy ms per step (a graph replay in the batch cells, a tick in
the stream cell), from the traced slice (compiled step)."""


def read(run):
    t = run.trace
    if t is None or not t["steps"] or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["steps"]
