"""Read a torch.profiler Chrome trace of the traced slice, device by
device: each device's operations (kernels, copies, memsets), their union
(busy time), the slice's length, the harness's host spans, and the
breakdown the result line carries."""

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


def _one_device(index, ops, lo, hi, spans):
    """One device's reading of the slice [lo, hi): its index, its ops
    (name, start_us, end_us), busy_s, first_us and last_us, seconds per op
    name, and its idle gaps (label, seconds), each named by the harness
    span open at its middle, else "host"."""
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
    return {"index": index, "ops": ops, "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "first_us": busy[0][0] if busy else None,
            "last_us": busy[-1][1] if busy else None,
            "per_name": per_name, "gaps": gaps}


def read_trace(trace, steps, span_names, devices):
    """`trace` is the parsed Chrome trace (a dict with traceEvents, or the
    list), covering one slice of `steps` steps wrapped in a "slice"
    annotation; `devices` are the keys (CUDA indices) of the run's
    devices, whose operations are read (others are left out). Returns a
    dict, or None without the slice: steps; window_s (the slice's length);
    devices, each device's own reading (_one_device) by key, in the order
    given; busy_s, the mean over the devices of the seconds in which one
    of its operations ran; device_ops, the 10 names with the most device
    seconds, as a mean over the devices; idle_gaps, the 10 longest gaps of
    any device, with more than one device each label suffixed by its
    device ("@cuda:2")."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ops, spans, window = {k: [] for k in devices}, [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        name = str(ev.get("name", ""))
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if cat in DEVICE_CATS:
            # its device: args.device, else the pid (a device's index is the
            # process of its events)
            device = (ev.get("args") or {}).get("device", ev.get("pid"))
            if device in ops:
                ops[device].append((name, start, end))
        elif cat == "user_annotation":
            if name == "slice":
                window = (start, end)
            elif name in span_names:
                spans.append((name, start, end))
    if window is None:
        return None
    lo, hi = window
    per_device = {k: _one_device(k, [(n, max(s, lo), min(e, hi)) for n, s, e in v
                                     if e > lo and s < hi], lo, hi, spans)
                  for k, v in ops.items()}
    n = max(len(per_device), 1)
    per_name, gaps = {}, []
    for k, d in per_device.items():
        for name, v in d["per_name"].items():
            per_name[name] = per_name.get(name, 0.0) + v
        suffix = f"@cuda:{k}" if len(per_device) > 1 else ""
        gaps += [(label + suffix, v) for label, v in d["gaps"]]
    gaps.sort(key=lambda g: -g[1])
    return {
        "steps": steps,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(d["busy_s"] for d in per_device.values()) / n,
        "devices": per_device,
        "device_ops": [[name[:NAME_CHARS], v / n] for name, v in
                       sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[label, v] for label, v in gaps[:TOP]],
    }


def mean_over_devices(trace, read):
    """The mean over the trace's devices of read(i, device's reading), i
    the device's place in the run's order; None without a trace, steps or
    devices, or where read gives None for any device."""
    if trace is None or not trace["steps"] or not trace["devices"]:
        return None
    values = [read(i, d) for i, d in enumerate(trace["devices"].values())]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)
