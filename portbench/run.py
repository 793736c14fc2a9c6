#!/usr/bin/env python3
"""The benchmark of mbe_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the checkout's root names the cell's configuration and
traffic; this script finds each by its name: the configuration in
configs/<name>.json, the traffic mix in traffic/<name>.json (read by
traffic/generator.py), the loop the window drives in
entries/<entry>.py (the traffic's "entry"), each per-layer metric's
reader in metrics/<name>.py. A run

1. makes its traffic pool from --seed on the card and builds and warms up
   the program (set-up, timed as `setup_s` from the start of this script);
2. measures for --seconds (the entry's loop; with --trace 1 a steady
   slice of it runs under torch.profiler);
3. reads the memory peak, frees the program, and recomputes a sample of
   channels, drawn from the seed, with the plain reference
   (reference/) from tick 0 over every tick the program ran; `correct`
   holds the program's outputs to the configuration's limits;
4. prints the checks on standard error and one JSON line on standard
   output: with --trace 0 the cell's end-to-end metrics, with --trace 1
   its per-layer metrics, the device's busy and traced seconds and the
   breakdown.

A cell of `chips: N` runs on cuda:0 .. cuda:N-1 (the run's `devices`;
`device`, the first, is where the existing entries put everything). Each
device is measured on its own: its memory peak, the harness's bytes on it,
whether outputs the consumer took came from it, and under --trace 1 its
operations in the traced slice. `count` is the number of devices that
ran the program: those whose reading fails none of the conditions in
`unmet`.

It exits non-zero, and prints no result, without a CUDA device (or with
fewer than the cell asks for), when the program used fewer devices than
the cell asks for or devices of different kinds, without the program, or
when jax, jaxlib, flax or mbe_tpu (top-level names, compared whole) are
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, this directory heads sys.path: put the checkout's root
# there instead, so that portbench.* and the program import and no file
# here shadows a module of the same name
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "mbe_tpu")
# host-side spans of the harness, which label the device's idle gaps
SPANS = ("push", "consume", "run_sequence", "readback")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_of(bench, workload):
    """(cell, configuration entry, its end-to-end and per-layer metric
    entries) of `workload` in BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]
    return cell, config, mine(bench["end_to_end"]), mine(bench["per_layer"])


class Run:
    """What a run knows: its arguments, configuration and traffic, its
    devices, the pool, the sample of channels checked, and what the window
    recorded (counters, the traced slice, the devices outputs came from).
    Entries and metric readers read and write it."""

    def __init__(self, args, cell, config, traffic, devices, torch):
        self.args, self.cell, self.config, self.traffic = args, cell, config, traffic
        self.torch = torch
        self.devices = [torch.device(d) for d in devices]
        self.distinct = list(dict.fromkeys(self.devices))
        self.device = self.devices[0]
        self.cuda = self.device.type == "cuda"
        self.codec = config["codec"]
        self.soft = bool(config["soft"])
        self.channels = int(traffic.get("channels", config["channels"]))
        self.counters = {}       # name -> number, read by metric readers
        self.trace = None        # the traced slice (read_trace), with --trace 1
        self.harness_bytes = {}  # device -> bytes of the harness's own buffers there
        self.output_devices = set()  # devices of the outputs the consumer took (took)
        self.out_pcm, self.out_words = [], []   # the sample's outputs per tick
        self.steps_per_call = 1  # compiled-step replays per step of the window's loop
        self._prof = None
        self._prof_done = None
        self._prof_steps = 0

    def sync(self):
        for d in self.distinct:
            if d.type == "cuda":
                self.torch.cuda.synchronize(d)

    def hold(self, *tensors):
        """Count `tensors` (None skipped) as the harness's own buffers, on
        the device where each lives: their bytes are not the program's
        memory."""
        for x in tensors:
            if x is not None:
                self.harness_bytes[x.device] = (self.harness_bytes.get(x.device, 0)
                                                + x.numel() * x.element_size())

    def took(self, *outputs):
        """Record the device of each output the consumer takes: a tensor,
        before any copy between devices, or the device itself."""
        for x in outputs:
            self.output_devices.add(x.device if isinstance(x, self.torch.Tensor) else x)

    @contextlib.contextmanager
    def span(self, name):
        """A host span of the harness: an annotation in the traced slice,
        which names the device's idle gaps in the breakdown."""
        if self._prof is not None:
            with self.torch.profiler.record_function(name):
                yield
        else:
            yield

    def warm_profiler(self):
        """Start and stop the profiler once in set-up (with --trace 1): its
        first start initialises CUPTI, which takes seconds."""
        if not self.args.trace:
            return
        prof = self.torch.profiler.profile(activities=self._activities())
        prof.start()
        self.torch.ones(8, device=self.device).add_(1)
        self.sync()
        prof.stop()

    def _activities(self):
        acts = [self.torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(self.torch.profiler.ProfilerActivity.CUDA)
        return acts

    def traced_step(self, i):
        """Called by the window before its step i (0, 1, ...): with --trace
        1 the profiler runs over steps trace_start .. trace_start +
        trace_steps - 1."""
        if not self.args.trace or self._prof_done is not None:
            return
        start = int(self.traffic["trace_start"])
        if i == start:
            self.sync()
            self._prof = self.torch.profiler.profile(activities=self._activities())
            self._prof.start()
            self._slice = self.torch.profiler.record_function("slice")
            self._slice.__enter__()
            self._prof_steps = 0
        elif i == start + int(self.traffic["trace_steps"]):
            self.end_trace()
        if self._prof is not None:
            self._prof_steps += 1

    def end_trace(self):
        """Stop the profiler at the traced slice's end (its last step or the
        window's end); the trace is read after the window."""
        if self._prof is None:
            return
        self.sync()
        self._slice.__exit__(None, None, None)
        self._prof.stop()
        self._prof_done, self._prof = self._prof, None

    def read_trace(self):
        """Export and read the traced slice (after the window)."""
        prof = self._prof_done
        if prof is None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        from portbench import trace_reader
        self.trace = trace_reader.read_trace(events, self._prof_steps * self.steps_per_call,
                                             SPANS, [d.index for d in self.distinct
                                                     if d.type == "cuda"])

    def record(self, pcm, words):
        """Keep one tick's outputs of the sample: pcm [S, 160] int16,
        words [S, 5] int32 (numpy, or tensors on the device)."""
        self.out_pcm.append(pcm)
        self.out_words.append(words)


def compare(limits, ref_pcm, ref_words, got_pcm, got_words):
    """The numbers compared, each with its limit: result words that differ,
    ticks that never came back, and the channel-frames (160 samples) whose
    PCM departs from the reference's by more than limits["pcm_bad_lsb"]
    LSB somewhere, per million compared. Returns (checks, failed
    channel-frames, facts printed beside them)."""
    import numpy as np
    n_expected = len(ref_pcm)
    n = min(len(got_pcm), n_expected)
    words_off = got_words[:n] != ref_words[:n]
    frame_lsb = np.abs(got_pcm[:n].astype(np.int32) - ref_pcm[:n].astype(np.int32)).max(axis=-1)
    frames = max(frame_lsb.size, 1)
    bad = frame_lsb > limits["pcm_bad_lsb"]
    checks = {
        "words_diff": (int(words_off.sum()), limits["words_diff"]),
        "missing_ticks": (int(n_expected - n), limits["missing_ticks"]),
        "pcm_bad_ppm": (1e6 * int(bad.sum()) / frames, limits["pcm_bad_ppm"]),
    }
    failed = int((bad | words_off.any(axis=-1)).sum()) + (n_expected - n) * ref_pcm.shape[1]
    facts = {"pcm_max_lsb": int(frame_lsb.max()) if frame_lsb.size else 0}
    return checks, failed, facts


def device_readings(run, peak_of, outputs):
    """Each distinct device's reading of the window: its index,
    memory_peak_bytes (peak_of[device]; None off CUDA, where it is not
    measured), harness_bytes, outputs (whether outputs the consumer took in
    the window came from it: it is in `outputs`) and, under --trace 1 on
    CUDA, busy_s in the traced slice (0 without one)."""
    out = []
    for d in run.distinct:
        r = {"device": str(d), "index": d.index, "memory_peak_bytes": peak_of[d],
             "harness_bytes": run.harness_bytes.get(d, 0), "outputs": d in outputs}
        if run.args.trace and d.type == "cuda":
            mine = run.trace["devices"].get(d.index) if run.trace else None
            r["busy_s"] = mine["busy_s"] if mine else 0.0
        out.append(r)
    return out


def unmet(reading):
    """The conditions for a device to count as used that its reading
    fails (none: it ran the program): program memory beyond the harness's
    own buffers in the window, where measured; outputs the consumer took
    produced on it; under --trace 1, device operations in the traced
    slice, where traced."""
    failed = []
    peak, held = reading["memory_peak_bytes"], reading["harness_bytes"]
    if peak is not None and peak <= held:
        failed.append(f"no program memory (window peak {peak} B, harness {held} B)")
    if not reading["outputs"]:
        failed.append("no outputs the consumer took came from it")
    if reading.get("busy_s", 1.0) <= 0:
        failed.append("no device operation in the traced slice")
    return failed


def reference_outputs(codec, soft, carry_enh, bits, rel, seeds, device, n_ticks, keep=None,
                      tf32=False):
    """The reference over ticks 0..n_ticks-1 for the channels of `bits`
    ([P, S, bytes] packed, unpacked here, or [P, S, rows, cols] bit planes,
    uint8; cycled) and `rel` (or None), each channel seeded by `seeds`:
    (pcm, words) numpy [T, S, ...] of the channels `keep` (all when None)."""
    from portbench.reference import runner as ref_runner
    from portbench.reference.pipeline import FRAME_SHAPES
    rows, cols = FRAME_SHAPES[codec]
    p = bits.shape[0]
    bits = bits.to(device)
    rel = None if rel is None else rel.to(device)
    runner = ref_runner.Runner(codec, soft, carry_enh, seeds, device, tf32=tf32)

    def frames_of(t):
        f = bits[t % p]
        if f.dim() == 2:                  # packed bytes: unpack them here
            f = ref_runner.unpack(f, rows * cols).reshape(-1, rows, cols)
        return f, None if rel is None else rel[t % p]
    try:
        return ref_runner.run_sequence(runner, frames_of, n_ticks, keep)
    finally:
        ref_runner.set_tf32(False)


def sample_of(seed, channels, traffic):
    """The channels checked: check_channels of them, drawn from the seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s = min(int(traffic["check_channels"]), channels)
    return np.sort(rng.choice(channels, s, replace=False))


def load_cell(workload, overrides=None):
    """(cell, configuration, traffic, end-to-end and per-layer metric
    entries) of `workload`."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config_entry, e2e_metrics, layer_metrics = cell_of(bench, workload)
    config = json.loads((ROOT / config_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    traffic.update(overrides or {})
    return cell, config, traffic, e2e_metrics, layer_metrics


def main(argv=None, device=None, overrides=None):
    """One run; returns the exit code. `device` and `overrides` (keys of
    the traffic mix, such as channels) are for the CPU tests of the
    harness: with a device given, the look for a CUDA device is skipped."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, config, traffic, e2e_metrics, layer_metrics = load_cell(args.workload, overrides)
    chips = int(cell["chips"])

    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
            return 1
        device = [f"cuda:{i}" for i in range(chips)]
    import mbe_tpu_torch  # noqa: F401  (the program; fails here without it)
    from portbench.traffic import generator

    run = Run(args, cell, config, traffic, [device] if isinstance(device, str) else device,
              torch)
    entry = load_module(HERE / "entries" / f"{traffic['entry']}.py",
                        f"portbench_entry_{traffic['entry']}")

    # ---- set-up: the pool from the seed, the program built and warmed up
    pool = generator.make_pool(run.codec, run.channels, traffic, args.seed, run.device)
    run.pool_seeds = pool.seeds.cpu().numpy()
    run.sample = sample_of(args.seed, run.channels, traffic)
    run.sample_ber = pool.ber.cpu().numpy()[run.sample]
    kinds = pool.kind.cpu().numpy()[:, run.sample]
    del pool.dbits, pool.kind
    entry.setup(run, pool)
    del pool
    run.warm_profiler()
    run.sync()
    setup_s = time.perf_counter() - T_START

    # ---- the measured window
    cuda_devices = [d for d in run.distinct if d.type == "cuda"]
    for d in cuda_devices:
        torch.cuda.reset_peak_memory_stats(d)
    run.output_devices.clear()
    t_window = time.perf_counter()
    e2e = entry.window(run)
    run.end_trace()
    t_window = time.perf_counter() - t_window
    peak_of = {d: torch.cuda.max_memory_allocated(d) if d.type == "cuda" else None
               for d in run.distinct}
    outputs = set(run.output_devices)
    got_pcm, got_words, n_ticks = entry.finish(run)
    attempted = int(e2e.pop("attempted"))
    for d in cuda_devices:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()

    run.read_trace()

    # ---- the devices the program used: as many as the cell asks for, of one kind
    readings = device_readings(run, peak_of, outputs)
    used = [r for r in readings if not unmet(r)]
    names = sorted({torch.cuda.get_device_name(r["device"]) if run.cuda else "cpu"
                    for r in used})
    if len(used) < chips or len(names) > 1:
        print(f"portbench: the program used {len(used)} device(s) of {names} where the cell "
              f"asks for {chips} of one kind (given: {', '.join(map(str, run.devices))})",
              file=sys.stderr)
        for r in readings:
            print(f"portbench: {r['device']}: " + ("; ".join(unmet(r)) or "used"),
                  file=sys.stderr)
        return 1
    full = max(readings, key=lambda r: r["memory_peak_bytes"] or 0)
    if run.cuda:
        run.counters["peak_mem_mib"] = ((full["memory_peak_bytes"] - full["harness_bytes"])
                                        / 2 ** 20)

    # ---- the check against the plain reference, after the window
    t_ref = time.perf_counter()
    bits, rel = run.ref_inputs()          # the pool as the program got it
    index = torch.as_tensor(run.sample, device=bits.device)
    ref_pcm, ref_words = reference_outputs(
        run.codec, run.soft, bool(config["carry_enh"]), bits.index_select(1, index),
        None if rel is None else rel.index_select(1, index), run.pool_seeds[run.sample],
        run.device, n_ticks)
    checks, failed, facts = compare(config["limits"], ref_pcm, ref_words, got_pcm, got_words)
    correct = all(v <= lim for v, lim in checks.values())
    t_ref = time.perf_counter() - t_ref

    # ---- the result
    e2e["setup_s"] = setup_s
    if args.trace:
        metrics = {}
        for m in layer_metrics:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        missing = [m["name"] for m in e2e_metrics if m["name"] not in e2e]
        if missing:
            raise RuntimeError(f"entry {traffic['entry']!r} measured no {missing}")
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in e2e_metrics}
    per_device = [{k: r[k] for k in ("index", "memory_peak_bytes", "harness_bytes", "busy_s")
                   if k in r} for r in readings]
    dev = {"platform": "gpu" if run.cuda else "cpu", "kind": names[0], "count": len(used),
           "memory_peak_bytes": int(full["memory_peak_bytes"] or 0), "per_device": per_device}
    result = {"correct": bool(correct), "attempted": attempted, "failed": int(failed),
              "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}

    found = forbidden_modules()
    if found:
        print(f"portbench: loaded modules it may not load: {found}", file=sys.stderr)
        return 1
    print(f"portbench: {args.workload} seed {args.seed}: {n_ticks} ticks x {len(run.sample)} "
          f"channels compared (BER levels {sorted(set(run.sample_ber.tolist()))}; frames "
          f"erased {int((kinds == 1).sum())}, silence {int((kinds == 2).sum())}, "
          f"tone {int((kinds == 3).sum())} per pool cycle); set-up {setup_s:.2f} s, window "
          f"{t_window:.2f} s, reference {t_ref:.2f} s", file=sys.stderr)
    print("portbench: " + ", ".join(f"{k} {v}" for k, v in facts.items()), file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"{k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
