"""Read a torch.profiler Chrome trace of the traced slice: the device's
operations (kernels, copies, memsets), their union (busy time), the
slice's length, the harness's host spans, and the breakdown the result
line carries."""

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(trace, steps, span_names):
    """`trace` is the parsed Chrome trace (a dict with traceEvents, or the
    list), covering one slice of `steps` steps wrapped in a "slice"
    annotation. Returns a dict: steps; window_s (the slice's length) and
    busy_s (seconds in which a device operation ran); ops, a list of
    (name, start_us, end_us); device_ops (the 10 names with the most
    device seconds); idle_gaps (the 10 longest gaps, each named by the
    harness span open at its middle, else "host")."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ops, spans, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        name = str(ev.get("name", ""))
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if cat in DEVICE_CATS:
            ops.append((name, start, end))
        elif cat == "user_annotation":
            if name == "slice":
                window = (start, end)
            elif name in span_names:
                spans.append((name, start, end))
    if window is None:
        return None
    lo, hi = window
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]
    busy = _union([(s, e) for _, s, e in ops])
    per_name = {}
    for n, s, e in ops:
        per_name[n] = per_name.get(n, 0.0) + (e - s) * 1e-6
    gaps, t = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            mid = 0.5 * (s + t)
            open_spans = [sp for sp in spans if sp[1] <= mid < sp[2]]
            # the innermost (latest-starting) span open at the gap's middle
            label = max(open_spans, key=lambda sp: sp[1])[0] if open_spans else "host"
            gaps.append((label, (s - t) * 1e-6))
        t = max(t, e)
    gaps.sort(key=lambda g: -g[1])
    return {
        "steps": steps,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "first_us": busy[0][0] if busy else None,
        "last_us": busy[-1][1] if busy else None,
        "ops": ops,
        "device_ops": [[n[:NAME_CHARS], v] for n, v in
                       sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[label, v] for label, v in gaps[:TOP]],
    }
