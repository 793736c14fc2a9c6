"""The harness on more than one device: the trace read device by device,
every per-step reader the mean of its devices' own readings (and on one
device exactly what the readers read before they read per device), the
rule that decides which devices a run used, and a run that used fewer
devices than its cell asks for failing without a result line."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import run as harness
from portbench import trace_reader
from portbench.metrics.roofline import device_channels

STEPS = 3
STEP_US = 240.0
WINDOW = (2.0, STEPS * STEP_US - 50.0)
CHANNELS = 8195  # split unevenly over 2 and 4 devices, as torch.tensor_split cuts it
# one step of the program on one device: (name, Chrome category, duration in us)
STEP = [
    ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 6.0),
    ("mbe_region_bit_domain", "kernel", 1.0),
    ("soft_decode_kernel", "kernel", 12.0),
    ("unpack_kernel", "kernel", 9.0),
    ("mbe_region_fsm", "kernel", 1.0),
    ("where_kernel", "kernel", 30.0),
    ("mbe_region_synthesis", "kernel", 1.0),
    ("voiced_sums_kernel", "kernel", 40.0),
    ("unvoiced_wola_kernel", "kernel", 25.0),
    ("mbe_region_fsm", "kernel", 1.0),
    ("select_kernel", "kernel", 5.0),
    ("mbe_region_commit", "kernel", 1.0),
    ("copy_kernel", "kernel", 8.0),
    ("Memset (Device)", "gpu_memset", 2.0),
    ("mbe_region_end", "kernel", 1.0),
    ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 10.0),
]
READERS = ["step.busy_ms", "step.gap_ms", "device.idle_share", "bit_domain.busy_ms",
           "fsm.busy_ms", "synthesis.busy_ms", "step.commit_busy_ms", "streaming.copy_busy_ms",
           "sequence.copy_busy_ms", "voiced_sums_roofline", "unvoiced_wola_roofline",
           "soft_decode_roofline", "device.idle_in_launch_ms"]


def device_ops(dev, steps=STEPS):
    """(name, category, start_us, end_us) of device `dev`'s operations:
    each device's steps start later and run longer than the one before,
    and some operations overlap the one before them (a second stream)."""
    out = []
    for s in range(steps):
        t = s * STEP_US + 5.0 + 3.7 * dev
        for i, (name, cat, dur) in enumerate(STEP):
            t += ((i * 7 + s * 5 + dev * 3) % 5) * 0.75 - 0.5
            end = t + dur * (1.0 + 0.1 * dev)
            out.append((name, cat, t, end))
            t = end
    return out


def host_spans(steps=STEPS):
    """The harness's spans: run_sequence, then consume, in each step."""
    return [(name, s * STEP_US + a, s * STEP_US + b) for s in range(steps)
            for name, a, b in (("run_sequence", 0.0, 100.0), ("consume", 100.0, 200.0))]


def chrome(devices, by="args"):
    """A Chrome trace as torch.profiler exports it: the slice, the
    harness's spans, the devices' operations interleaved in time (their
    device in args.device, or with by="pid" in the pid alone), a device's
    projection of an annotation and a flow event, which are not
    operations."""
    def x(cat, name, start, end, pid, **extra):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": 1, "ts": start,
                "dur": end - start, **extra}
    events = [x("user_annotation", "slice", *WINDOW, 4242),
              x("gpu_user_annotation", "slice", *WINDOW, 0),
              {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7, "ts": 9.0, "id": 1}]
    events += [x("user_annotation", n, s, e, 4242) for n, s, e in host_spans()]
    for dev in devices:
        for name, cat, s, e in device_ops(dev):
            extra = {"args": {"device": dev, "stream": 7}} if by == "args" else {}
            events.append(x(cat, name, s, e, dev, **extra))
    return {"traceEvents": sorted(events, key=lambda ev: ev["ts"])}


def _event(name, device_type, index, start, end):
    return SimpleNamespace(name=name, device_type=device_type, device_index=index,
                           time_range=SimpleNamespace(start=start, end=end))


def profiler(devices):
    """A stopped profiler's events(): the slice, the program's
    mbe.graph.replay ranges and a runtime call on the host, the devices'
    operations, and a device's projection of the slice."""
    events = [_event("slice", DeviceType.CPU, -1, *WINDOW),
              _event("cudaGraphLaunch", DeviceType.CPU, -1, 0.0, 900.0),
              _event("slice", DeviceType.CUDA, 0, *WINDOW)]
    for s in range(STEPS):
        for a, b in ((2.0, 60.0), (150.0, 230.0)):
            events.append(_event("mbe.graph.replay", DeviceType.CPU, -1,
                                 s * STEP_US + a, s * STEP_US + b))
    for dev in devices:
        events += [_event(n, DeviceType.CUDA, dev, s, e) for n, _, s, e in device_ops(dev)]
    return SimpleNamespace(events=lambda: events)


def traced_run(devices, channels=CHANNELS, by="args", keep=None):
    """A run as the metric readers see it after a traced window on
    `devices` (CUDA indices), reading the devices `keep` (all by
    default)."""
    keep = devices if keep is None else keep
    trace = trace_reader.read_trace(chrome(devices, by), STEPS, harness.SPANS, keep)
    return SimpleNamespace(trace=trace, channels=channels, codec="ambe2450", soft=True,
                           _prof_done=profiler(devices))


def read(name, run):
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                 "portbench_metric_" + name.replace(".", "_"))
    return reader.read(run)


# What the readers read, before they read per device, on the one-device
# traces of devices 0 and 2 (the parent commit's portbench on these traces)
PARENT = {0: {"step.busy_ms": 0.1515,
              "step.gap_ms": 0.06449999999999997,
              "device.idle_share": 31.96107784431138,
              "bit_domain.busy_ms": 0.021999999999999995,
              "fsm.busy_ms": 0.03699999999999999,
              "synthesis.busy_ms": 0.06599999999999999,
              "step.commit_busy_ms": 0.011000000000000001,
              "streaming.copy_busy_ms": 0.016999999999999998,
              "sequence.copy_busy_ms": 0.016999999999999998,
              "voiced_sums_roofline": 35.996843283582095,
              "unvoiced_wola_roofline": 30.84729313432836,
              "soft_decode_roofline": 41.85940815638693,
              "device.idle_in_launch_ms": 0.05416666666666667,
              "busy_s": 0.0004545,
              "window_s": 0.000668,
              "device_ops": [["voiced_sums_kernel", 0.00011999999999999999],
                             ["where_kernel", 8.999999999999999e-05],
                             ["unvoiced_wola_kernel", 7.5e-05],
                             ["soft_decode_kernel", 3.6e-05],
                             ["Memcpy DtoH (Device -> Pinned)", 2.9999999999999997e-05],
                             ["unpack_kernel", 2.7e-05],
                             ["copy_kernel", 2.4e-05],
                             ["Memcpy HtoD (Pinned -> Device)", 1.8e-05],
                             ["select_kernel", 1.4999999999999999e-05],
                             ["Memset (Device)", 6e-06]],
              "idle_gaps": [["host", 7.2e-05],
                            ["host", 7.2e-05],
                            ["consume", 1.75e-05],
                            ["run_sequence", 2.4999999999999998e-06],
                            ["run_sequence", 2.4999999999999998e-06],
                            ["run_sequence", 2.4999999999999998e-06],
                            ["consume", 2.4999999999999998e-06],
                            ["run_sequence", 2.4999999999999998e-06],
                            ["run_sequence", 2.4999999999999998e-06],
                            ["consume", 2.4999999999999998e-06]]},
          2: {"step.busy_ms": 0.17626666666666665,
              "step.gap_ms": 0.04285000000000002,
              "device.idle_share": 20.83832335329342,
              "bit_domain.busy_ms": 0.026399999999999965,
              "fsm.busy_ms": 0.04440000000000002,
              "synthesis.busy_ms": 0.0792,
              "step.commit_busy_ms": 0.011766666666666653,
              "streaming.copy_busy_ms": 0.01599999999999999,
              "sequence.copy_busy_ms": 0.01599999999999999,
              "voiced_sums_roofline": 29.997369402985075,
              "unvoiced_wola_roofline": 25.706077611940298,
              "soft_decode_roofline": 34.88284013032248,
              "device.idle_in_launch_ms": 0.03565000000000002,
              "busy_s": 0.0005288,
              "window_s": 0.000668,
              "device_ops": [["voiced_sums_kernel", 0.000144],
                             ["where_kernel", 0.000108],
                             ["unvoiced_wola_kernel", 8.999999999999999e-05],
                             ["soft_decode_kernel", 4.319999999999995e-05],
                             ["unpack_kernel", 3.239999999999996e-05],
                             ["copy_kernel", 2.689999999999995e-05],
                             ["Memcpy DtoH (Device -> Pinned)", 2.4e-05],
                             ["Memcpy HtoD (Pinned -> Device)", 2.1600000000000007e-05],
                             ["select_kernel", 1.8e-05],
                             ["mbe_region_fsm", 7.200000000000059e-06]],
              "idle_gaps": [["host", 4.140000000000003e-05],
                            ["host", 4.140000000000003e-05],
                            ["run_sequence", 1.065e-05],
                            ["run_sequence", 2.4999999999999998e-06],
                            ["consume", 2.4999999999999998e-06],
                            ["consume", 2.4999999999999998e-06],
                            ["run_sequence", 2.4999999999999998e-06],
                            ["consume", 2.4999999999999998e-06],
                            ["consume", 2.4999999999999998e-06],
                            ["run_sequence", 2.4999999999999998e-06]]}}


@pytest.mark.parametrize("by", ["args", "pid"])
@pytest.mark.parametrize("dev", sorted(PARENT))
def test_one_device_reads_as_before(dev, by):
    run = traced_run([dev], by=by)
    want = PARENT[dev]
    for name in READERS:
        assert read(name, run) == want[name], name
    for key in ("busy_s", "window_s", "device_ops", "idle_gaps"):
        assert run.trace[key] == want[key], key


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("n", [2, 4])
def test_reader_is_the_mean_of_its_devices(n, name):
    """Each per-step reader on n devices reads the mean of its readings of
    each device's operations alone, a roofline at the device's own share
    of the channels."""
    parts = device_channels(CHANNELS, n)
    alone = [read(name, traced_run([d], channels=c)) for d, c in zip(range(n), parts)]
    assert None not in alone
    assert read(name, traced_run(list(range(n)))) == sum(alone) / n


def test_roofline_shares_are_tensor_splits():
    assert device_channels(CHANNELS, 4) == [2049, 2049, 2049, 2048]
    assert device_channels(CHANNELS, 2) == [4098, 4097]
    assert device_channels(CHANNELS, 1) == [CHANNELS]


@pytest.mark.parametrize("n", [2, 4])
def test_trace_is_read_device_by_device(n):
    """busy_s is the mean of the devices' busy seconds, device_ops the mean
    seconds per name, and the idle gaps each device's own, named with the
    device."""
    trace = traced_run(list(range(n))).trace
    alone = [traced_run([d]).trace for d in range(n)]
    assert list(trace["devices"]) == list(range(n))
    assert trace["window_s"] == alone[0]["window_s"]
    assert trace["busy_s"] == sum(a["busy_s"] for a in alone) / n
    for d, a in zip(trace["devices"].values(), alone):
        assert d == a["devices"][d["index"]]
    per_name = {}
    for d, a in enumerate(alone):
        for name, v in a["devices"][d]["per_name"].items():
            per_name[name] = per_name.get(name, 0.0) + v
    want = sorted(per_name.items(), key=lambda kv: -kv[1])[:trace_reader.TOP]
    assert trace["device_ops"] == [[name, v / n] for name, v in want]
    gaps = [(label + f"@cuda:{d}", v) for d, a in enumerate(alone) for label, v in
            a["devices"][d]["gaps"]]
    want = sorted(gaps, key=lambda g: -g[1])[:trace_reader.TOP]
    assert trace["idle_gaps"] == [list(g) for g in want]
    assert all("@cuda:" in label for label, _ in trace["idle_gaps"])


def test_other_devices_are_left_out():
    """Operations of a device outside the run's are not read."""
    assert traced_run([0, 1, 5], keep=[0, 1]).trace == traced_run([0, 1]).trace
    assert list(traced_run([3], keep=[3, 6]).trace["devices"][6]["ops"]) == []


def reading(peak=5_000, held=1_000, outputs=True, **extra):
    return {"device": "cuda:0", "index": 0, "memory_peak_bytes": peak, "harness_bytes": held,
            "outputs": outputs, **extra}


@pytest.mark.parametrize("r,failed", [
    (reading(), []),
    (reading(busy_s=0.01), []),
    (reading(outputs=False), ["no outputs"]),
    (reading(peak=1_000), ["no program memory"]),
    (reading(peak=0, held=0), ["no program memory"]),
    (reading(peak=1_000, outputs=False), ["no program memory", "no outputs"]),
    (reading(busy_s=0.0), ["no device operation"]),
    (reading(peak=None), []),
    (reading(peak=None, outputs=False), ["no outputs"]),
], ids=["used", "traced", "memory-no-outputs", "outputs-no-memory", "nothing-held",
        "neither", "traced-idle", "cpu", "cpu-no-outputs"])
def test_device_counts_only_with_memory_and_outputs(r, failed):
    got = harness.unmet(r)
    assert len(got) == len(failed)
    for g, f in zip(got, failed):
        assert g.startswith(f), (g, f)


def test_device_readings_per_device():
    import torch
    devs = [torch.device("cuda", i) for i in range(3)]
    trace = {"devices": {0: {"busy_s": 0.25}, 1: {"busy_s": 0.0}}}
    run = SimpleNamespace(distinct=devs, harness_bytes={devs[0]: 10, devs[2]: 30},
                          args=SimpleNamespace(trace=1), trace=trace)
    got = harness.device_readings(run, {d: 100 * (i + 1) for i, d in enumerate(devs)},
                                  {devs[0], devs[1]})
    assert [(r["index"], r["memory_peak_bytes"], r["harness_bytes"], r["outputs"], r["busy_s"])
            for r in got] == [(0, 100, 10, True, 0.25), (1, 200, 0, True, 0.0),
                              (2, 300, 30, False, 0.0)]
    assert [bool(harness.unmet(r)) for r in got] == [False, True, True]
    run.args.trace = 0
    assert all("busy_s" not in r for r in harness.device_readings(run, {d: 1 for d in devs}, set()))


SMALL = dict(channels=24, check_channels=24, pool_ticks=4, warmup_ticks=2, warmup_chunks=1,
             trace_start=1, trace_steps=2)


def run_main(workload, capsys, device, chips=None, monkeypatch=None, trace=0):
    if chips is not None:
        load_cell = harness.load_cell

        def with_chips(*a, **k):
            cell, *rest = load_cell(*a, **k)
            return (dict(cell, chips=chips), *rest)
        monkeypatch.setattr(harness, "load_cell", with_chips)
    from mbe_tpu_torch import pipeline
    pipeline.clear_compiled()
    rc = harness.main(["--workload", workload, "--seed", str(2 ** 31 + 91), "--seconds", "0.3",
                       "--trace", str(trace)], device=device, overrides=SMALL)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("device", ["cpu", ["cpu"]], ids=["name", "list"])
@pytest.mark.parametrize("workload", ["imbe7200-hard.stream", "imbe7200-hard.batch"])
def test_one_device_run_counts_one(workload, device, capsys):
    rc, out, _ = run_main(workload, capsys, device)
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True
    dev = result["device"]
    assert dev["count"] == 1 and len(dev["per_device"]) == 1
    assert set(dev["per_device"][0]) == {"index", "memory_peak_bytes", "harness_bytes"}


@pytest.mark.parametrize("workload", ["imbe7200-hard.stream", "ambe2450-soft.batch"])
def test_fewer_distinct_devices_than_chips_fails(workload, capsys, monkeypatch):
    """Two shards on one device, where the cell asks for two: no result."""
    rc, out, err = run_main(workload, capsys, ["cpu", "cpu"], chips=2, monkeypatch=monkeypatch)
    assert rc != 0
    assert not [line for line in out.splitlines() if line.startswith("{")]
    assert "used 1 device(s)" in err and "asks for 2" in err and "portbench: cpu: used" in err


@pytest.mark.parametrize("workload", ["imbe7200-hard.stream", "imbe7200-hard.batch"])
def test_device_without_outputs_fails(workload, capsys, monkeypatch):
    """A program whose outputs the consumer never took from the device
    ran on no device: no result."""
    monkeypatch.setattr(harness.Run, "took", lambda self, *outputs: None)
    rc, out, err = run_main(workload, capsys, "cpu")
    assert rc != 0 and "{" not in out
    assert "portbench: cpu: no outputs the consumer took came from it" in err


CARD = dict(channels=4096, trace_start=1, trace_steps=2)


def run_apart(workload, device=None, chips=None):
    """One traced run on the card in a process of its own, as the
    benchmark's runs are (a profiler session leaves state behind in its
    process): (exit code, stdout, stderr). `chips` overrides the cell's."""
    argv = ["--workload", workload, "--seed", str(2 ** 31 + 93), "--seconds", "1", "--trace", "1"]
    code = "\n".join([
        "import sys",
        "from portbench import run",
        f"chips = {chips!r}",
        "load_cell = run.load_cell",
        "def with_chips(*a, **k):",
        "    cell, *rest = load_cell(*a, **k)",
        "    return (cell if chips is None else dict(cell, chips=chips), *rest)",
        "run.load_cell = with_chips",
        f"sys.exit(run.main({argv!r}, device={device!r}, overrides={CARD!r}))"])
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=600)
    return p.returncode, p.stdout, p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["imbe7200-hard.stream", "ambe2450-soft.batch",
                                      "imbe7200-hard.batch"])
def test_cell_counts_one_card(workload, cuda):
    """On the card, each cell's run reports the one device it used, with
    its window peak, harness bytes and busy seconds."""
    rc, out, err = run_apart(workload)
    assert rc == 0, err[-2000:]
    dev = json.loads(out.strip().splitlines()[-1])["device"]
    assert dev["count"] == 1 and len(dev["per_device"]) == 1, dev
    (one,) = dev["per_device"]
    assert one["index"] == 0 and one["memory_peak_bytes"] == dev["memory_peak_bytes"]
    assert one["memory_peak_bytes"] > one["harness_bytes"] and 0 < one["busy_s"] == dev["busy_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["imbe7200-hard.stream", "imbe7200-hard.batch"])
def test_two_shards_on_one_card_fail(workload, cuda):
    """cuda:0 twice, where the cell asks for two devices: no result."""
    rc, out, err = run_apart(workload, device=["cuda:0", "cuda:0"], chips=2)
    assert rc != 0
    assert not [line for line in out.splitlines() if line.startswith("{")]
    assert "portbench: cuda:0: used" in err, err[-2000:]
