"""The readers of the program's own tracing: regions.py (device time per
region, between the program's mbe_region_* marks) and program_spans.py
(the program's span counters, and device-idle time inside its ranges), on
synthetic traces; both read None where the program has neither."""

import json
import tempfile
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import run as harness
from portbench.metrics import program_spans, regions

# (name, start_us, end_us), as trace_reader keeps them; two steps, the
# first preceded by a copy that the slice catches before any mark
OPS = [
    ("Memcpy HtoD (Pinned -> Device)", 0.0, 10.0),
    ("mbe_region_bit_domain", 10.0, 11.0),
    ("unpack_kernel", 11.0, 31.0),
    ("mbe_region_fsm", 31.0, 32.0),
    ("where_kernel", 32.0, 72.0),
    ("mbe_region_synthesis", 72.0, 73.0),
    ("voiced_sums_kernel", 73.0, 173.0),
    ("mbe_region_fsm", 173.0, 174.0),
    ("select_kernel", 174.0, 184.0),
    ("mbe_region_commit", 184.0, 185.0),
    ("copy_kernel", 185.0, 195.0),
    ("mbe_region_end", 195.0, 196.0),
    ("Memcpy DtoH (Device -> Pinned)", 196.0, 216.0),
    ("mbe_region_bit_domain", 216.0, 217.0),
    ("unpack_kernel", 217.0, 237.0),
    ("mbe_region_end", 237.0, 238.0),
]


def _run(ops, steps):
    """A run whose traced slice holds `ops` on one device."""
    return SimpleNamespace(trace={"steps": steps, "devices": {0: {"ops": list(reversed(ops))}}})


def test_region_seconds_sums_each_op_into_the_last_mark():
    totals = regions.region_seconds(OPS)
    us = {k: round(v * 1e6, 6) for k, v in totals.items()}
    assert us == {"outside": 10 + 1 + 20 + 1, "bit_domain": 21 + 21, "fsm": 41 + 11,
                  "synthesis": 101, "commit": 11}
    assert sum(totals.values()) * 1e6 == pytest.approx(sum(e - s for _, s, e in OPS))


def test_busy_ms_per_step_and_none_without_marks():
    run = _run(OPS, steps=2)
    assert regions.busy_ms(run, "fsm") == pytest.approx(1e-3 * 52 / 2)
    assert regions.busy_ms(run, regions.OUTSIDE) == pytest.approx(1e-3 * 32 / 2)
    unmarked = [op for op in OPS if not op[0].startswith("mbe_region_")]
    assert regions.busy_ms(_run(unmarked, 2), "fsm") is None
    assert regions.busy_ms(SimpleNamespace(trace=None), "fsm") is None


def _events(ops, ranges, window=(0.0, 300.0)):
    """events_of's tuples: the slice, device 0's kernels, the ranges and a
    host runtime call."""
    return ([("host", "slice", *window, None)]
            + [("device", n, s, e, 0) for n, s, e in ops]
            + [("host", n, s, e, None) for n, s, e in ranges]
            + [("host", "cudaGraphLaunch", 0.0, 500.0, None)])


def test_idle_in_counts_only_idle_time_inside_the_ranges():
    ops = [("a", 10.0, 50.0), ("b", 40.0, 60.0), ("c", 100.0, 150.0), ("d", 280.0, 400.0)]
    # idle in the slice: [0, 10), [60, 100), [150, 280)
    ranges = [("mbe.graph.replay", 5.0, 70.0), ("mbe.graph.replay", 90.0, 95.0),
              ("mbe.graph.replay", 140.0, 160.0), ("mbe.graph.replay", 155.0, 170.0),
              ("mbe.stream.wait", 160.0, 280.0)]
    events = _events(ops, ranges)
    # 5 (5-10) + 10 (60-70) + 5 (90-95) + 20 (150-170)
    assert program_spans.idle_in(events, "mbe.graph.replay", 0) == pytest.approx(40.0)
    assert program_spans.idle_in(events, "mbe.stream.wait", 0) == pytest.approx(120.0)
    assert program_spans.idle_in(events, "mbe.stream.stage", 0) is None
    # another device's kernels do not fill device 0's idle time
    other = events + [("device", "e", 60.0, 100.0, 1)]
    assert program_spans.idle_in(other, "mbe.graph.replay", 0) == pytest.approx(40.0)
    # device 1 idles but in [60, 100): inside the ranges [5, 60) and [140, 170)
    assert program_spans.idle_in(other, "mbe.graph.replay", 1) == pytest.approx(55.0 + 30.0)


def test_idle_in_ms_none_without_a_profiler():
    run = SimpleNamespace(_prof_done=None, trace={"steps": 4})
    assert program_spans.idle_in_ms(run, "mbe.graph.replay") is None


def test_events_of_a_stopped_profiler():
    """The profiler's own events carry the ranges, on one clock; the
    trace's export (the harness's, before this) does not consume them."""
    import torch
    from mbe_tpu_torch.utils import profiling
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("slice"):
        with profiling.span("portbench.test.range"):
            torch.ones(8).cumsum(0)
    prof.stop()
    prof.export_chrome_trace(str(Path(tempfile.mkdtemp()) / "t.json"))
    events = program_spans.events_of(prof)
    (_, _, s0, e0, _), = [e for e in events if e[:2] == ("host", "slice")]
    (_, _, s1, e1, _), = [e for e in events if e[:2] == ("host", "portbench.test.range")]
    assert s0 <= s1 < e1 <= e0
    # no device op on the CPU: the whole range is device-idle
    assert program_spans.idle_in(events, "portbench.test.range", 0) == pytest.approx(e1 - s1)


def test_mean_ms_reads_the_program_counters(monkeypatch):
    from mbe_tpu_torch.utils import profiling
    assert program_spans.mean_ms("portbench.test.never") is None
    for _ in range(4):
        with profiling.span("portbench.test.span"):
            pass
    count, ns = profiling.snapshot()["portbench.test.span"]
    assert program_spans.mean_ms("portbench.test.span") == pytest.approx(1e-6 * ns / count)
    # a program without the counters (older than its spans) reads None
    monkeypatch.delattr(profiling, "snapshot")
    assert program_spans.mean_ms("portbench.test.span") is None


def test_traced_cpu_run_reports_the_stream_counters(capsys):
    """A whole traced run of the stream cell on the CPU: the span counters'
    metrics are in the line (host times of this CPU, not of a card); the
    device-trace ones are not, as the CPU trace holds no device op."""
    small = dict(channels=24, check_channels=24, pool_ticks=4, warmup_ticks=2, trace_start=1,
                 trace_steps=2)
    rc = harness.main(["--workload", "imbe7200-hard.stream", "--seed", str(2 ** 31 + 5),
                       "--seconds", "0.3", "--trace", "1"], device="cpu", overrides=small)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    m = result["metrics"]
    for name in ("streaming.stage_ms", "streaming.wait_ms", "streaming.copy_out_ms"):
        assert m[name]["unit"] == "ms" and m[name]["value"] > 0, name
    for name in ("bit_domain.busy_ms", "streaming.copy_busy_ms", "step.launch_ms",
                 "device.idle_in_launch_ms"):
        assert name not in m, name


@pytest.mark.cuda
def test_events_of_a_traced_replay_on_card(cuda):
    """On the card, the profiler's events hold a graph replay's device
    operations, its region marks among them, apart from the device's
    projections of host annotations; the idle time inside the replay's
    ranges is read from them."""
    import torch
    from mbe_tpu_torch import pipeline
    from mbe_tpu_torch.models import state as st
    frame = torch.zeros((1024, 8, 23), dtype=torch.int32, device=cuda)
    compiled = pipeline.CompiledStep("imbe7200", st.init_state(1024, device=cuda))
    compiled(frame)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    with torch.profiler.record_function("slice"):
        for _ in range(2):
            compiled(frame)
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(str(Path(tempfile.mkdtemp()) / "t.json"))
    events = program_spans.events_of(prof)
    device = [name for kind, name, _, _, _ in events if kind == "device"]
    assert device.count("mbe_region_bit_domain") == 2 and device.count("mbe_region_end") == 2
    assert "slice" not in device and "mbe.graph.replay" not in device
    assert len(device) > 500
    assert {index for kind, _, _, _, index in events if kind == "device"} == {0}
    assert program_spans.idle_in(events, "mbe.graph.replay", 0) >= 0.0
