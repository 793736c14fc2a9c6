"""ms per step in which the device idles between back-to-back replays
(compiled step): the span from the slice's first device operation to its
last, per step, less the busy time per step."""


def read(run):
    t = run.trace
    if t is None or not t["steps"] or t["first_us"] is None:
        return None
    span_s = (t["last_us"] - t["first_us"]) * 1e-6
    return 1e3 * (span_s - t["busy_s"]) / t["steps"]
