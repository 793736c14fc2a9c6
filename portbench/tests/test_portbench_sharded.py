"""The four-card cell imbe7200-hard.sharded4 on the CPU: it loads, a run
of its entry over four CPU shards is correct where the cell is let to
count one device, it fails without a result line where the cell asks for
four devices and gets one, and the sharding layer's two readers read the
program's mbe.shard.round span (the largest device's idle, None without
the span)."""

import json
from types import SimpleNamespace

import pytest

from portbench import run as harness

CELL = "imbe7200-hard.sharded4"
SEED = 2 ** 31 + 4097


def read(name, run):
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                 "portbench_metric_" + name.replace(".", "_"))
    return reader.read(run)


def test_cell_loads():
    cell, config, traffic, e2e, layer = harness.load_cell(CELL)
    assert cell["chips"] == 4 and cell["config"] == config["name"] == "p25-imbe7200-hard-site4"
    assert traffic["entry"] == "sharded" and (harness.HERE / "entries" / "sharded.py").is_file()
    assert config["channels"] == 131072 and config["codec"] == "imbe7200"
    assert not config["soft"] and config["int16"] and config["reduced"] == []
    assert [m["name"] for m in e2e] == ["frames_per_s", "setup_s"]
    names = {m["name"] for m in layer}
    assert {"shard.round_ms", "shard.idle_in_round_ms", "step.busy_ms",
            "device.idle_share"} <= names
    assert not names & {"streaming.copy_busy_ms", "soft_decode_roofline"}


def run_cell(capsys, monkeypatch, chips, trace=0, **overrides):
    if chips is not None:
        load_cell = harness.load_cell

        def with_chips(*a, **k):
            cell, *rest = load_cell(*a, **k)
            return (dict(cell, chips=chips), *rest)
        monkeypatch.setattr(harness, "load_cell", with_chips)
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3",
                       "--trace", str(trace)], device=["cpu"] * 4,
                      overrides={"channels": 64, **overrides})
    out, err = capsys.readouterr()
    return rc, [line for line in out.splitlines() if line.startswith("{")], err


def test_four_cpu_shards_are_correct(capsys, monkeypatch):
    """Four shards of 16 channels, the cell let to count one device: every
    sampled channel of every tick exact against the reference."""
    rc, lines, err = run_cell(capsys, monkeypatch, chips=1)
    assert rc == 0, err[-2000:]
    result = json.loads(lines[-1])
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["words_diff"]["value"] == 0
    assert result["device"]["count"] == 1
    assert result["metrics"]["frames_per_s"]["value"] > 0
    assert "64 channels compared" in err


def test_traced_run_reads_the_round_span(capsys, monkeypatch):
    """Traced on the CPU (a slice from the second call): the round's
    counter is read; the idle reader finds no device to read."""
    rc, lines, err = run_cell(capsys, monkeypatch, chips=1, trace=1, pool_ticks=4,
                              trace_start=1)
    assert rc == 0, err[-2000:]
    metrics = json.loads(lines[-1])["metrics"]
    assert metrics["shard.round_ms"]["value"] > 0
    assert "shard.idle_in_round_ms" not in metrics


def test_one_device_where_four_are_asked_fails(capsys, monkeypatch):
    """Four shards on one device, where the cell asks for four: no result."""
    rc, lines, err = run_cell(capsys, monkeypatch, chips=None)
    assert rc != 0 and lines == []
    assert "used 1 device(s)" in err and "asks for 4" in err


def _event(kind, name, start, end, device=None):
    return (kind, name, start, end, device)


def rounds_events(devices, rounds=3, period=100.0):
    """events_of's tuples: a slice over `rounds` rounds, the host inside
    mbe.shard.round for [0, 60) of each period, and device d busy for
    [10 * d, 80) of each period (so device d idles 10 * d us of each
    round, at its start)."""
    events = [_event("host", "slice", 0.0, rounds * period)]
    for r in range(rounds):
        t = r * period
        events.append(_event("host", "mbe.shard.round", t, t + 60.0))
        events += [_event("device", "step", t + 10.0 * d, t + 80.0, d) for d in devices]
    return events


@pytest.mark.parametrize("devices", [[0], [0, 1, 2, 3], [3, 1]], ids=["1", "4", "2-unordered"])
def test_idle_in_round_is_the_worst_device(devices):
    from portbench.metrics import program_spans
    reader = harness.load_module(harness.HERE / "metrics" / "shard.idle_in_round_ms.py",
                                 "portbench_metric_shard_idle_in_round_ms")
    events = rounds_events(devices)
    each = [program_spans.idle_in(events, "mbe.shard.round", d) for d in devices]
    assert each == [pytest.approx(3 * 10.0 * d) for d in devices]
    assert reader.worst_ms(events, devices, 3) == pytest.approx(1e-3 * 10.0 * max(devices))
    # a run whose stopped profiler recorded those events
    from torch.autograd import DeviceType
    prof = SimpleNamespace(events=lambda: [
        SimpleNamespace(name=n, device_type=DeviceType.CPU if kind == "host" else DeviceType.CUDA,
                        device_index=-1 if d is None else d,
                        time_range=SimpleNamespace(start=s, end=e))
        for kind, n, s, e, d in events])
    run = SimpleNamespace(_prof_done=prof, trace={"steps": 3, "devices": {d: {} for d in devices}})
    assert read("shard.idle_in_round_ms", run) == pytest.approx(1e-3 * 10.0 * max(devices))


def test_readers_none_without_the_span(monkeypatch):
    """A program without mbe.shard.round (the parent's) reads None on
    both readers; with the span's counters, the round reader reads their
    mean."""
    reader = harness.load_module(harness.HERE / "metrics" / "shard.idle_in_round_ms.py",
                                 "portbench_metric_shard_idle_in_round_ms")
    events = [e for e in rounds_events([0, 1, 2, 3]) if e[1] != "mbe.shard.round"]
    assert reader.worst_ms(events, [0, 1, 2, 3], 3) is None
    assert read("shard.idle_in_round_ms", SimpleNamespace(_prof_done=None, trace=None)) is None
    from mbe_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "snapshot", lambda: {})
    assert read("shard.round_ms", SimpleNamespace()) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {"mbe.shard.round": (4, 10_000_000)})
    assert read("shard.round_ms", SimpleNamespace()) == pytest.approx(2.5)


@pytest.mark.cuda
def test_four_shards_on_one_card(cuda):
    """The cell on the card with its chips patched to 1 and four shards on
    cuda:0 (4096 channels, traced from the second call), in a process of
    its own: correct, and both sharding readers read."""
    import subprocess
    import sys
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "2", "--trace", "1"]
    code = "\n".join([
        "import sys",
        "from portbench import run",
        "load_cell = run.load_cell",
        "def with_chips(*a, **k):",
        "    cell, *rest = load_cell(*a, **k)",
        "    return (dict(cell, chips=1), *rest)",
        "run.load_cell = with_chips",
        f"sys.exit(run.main({argv!r}, device=['cuda:0'] * 4, "
        "overrides={'channels': 4096, 'trace_start': 1}))"])
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["count"] == 1
    assert {"shard.round_ms", "shard.idle_in_round_ms", "step.busy_ms"} <= set(result["metrics"])


@pytest.mark.cuda
def test_control_fails_the_limits(cuda):
    """The reference with TF32 on in the program's place, at the cell's
    limits, is not correct (as test_portbench_control.py for the one-chip
    cells)."""
    from portbench import control
    rows = control.main(["--workload", CELL, "--seeds", "2147483659", "--ticks", "40",
                         "--channels", "2048"])
    assert rows and all(not r["correct"] for r in rows), rows
