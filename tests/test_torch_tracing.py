"""The port's tracing on the CPU: host spans (mbe_tpu_torch.utils.spans,
as profiling.span / profiling.snapshot) and region marks
(mbe_tpu_torch.ops.cuda.marks).

A span counts and times every entry, and opens a torch.profiler range
only while the profiler records. A mark does nothing on the CPU (its
library is never loaded), each body issues its marks in the step's order,
and the outputs of pipeline.step, CompiledStep and StreamingDecoder on the
e2e goldens are bit-identical with the marks' calls taken out. The card's
traced replays and ticks are in tests/test_torch_cuda.py."""

import time

import numpy as np
import pytest
import torch

from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops.cuda import marks
from mbe_tpu_torch.parallel.streaming import StreamingDecoder
from mbe_tpu_torch.utils import graphs, profiling, spans

torch.set_num_threads(1)

IMBE_STEP = ["bit_domain", "fsm", "synthesis", "commit"]
AMBE_STEP = ["bit_domain", "fsm", "synthesis", "fsm", "commit"]


def test_span_counts_and_accumulates_ns():
    name = "test.span.counts"
    before = profiling.snapshot().get(name, (0, 0))
    for _ in range(3):
        with profiling.span(name):
            time.sleep(0.002)
    count, ns = profiling.snapshot()[name]
    assert count - before[0] == 3
    assert 6e6 <= ns - before[1] < 2e9
    assert profiling.span is spans.span and profiling.snapshot is spans.snapshot


def test_span_counts_a_block_that_raises():
    name = "test.span.raises"
    before = profiling.snapshot().get(name, (0, 0))[0]
    with pytest.raises(ValueError):
        with profiling.span(name):
            raise ValueError("inside")
    assert profiling.snapshot()[name][0] == before + 1


def test_span_range_only_while_the_profiler_records():
    """The range is in the trace of a block the profiler records, and a
    span entered with no profiler running opens none (record_function is
    not called)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("test.span.traced"):
            torch.ones(16).cumsum(0)
    assert [e.name for e in prof.events()].count("test.span.traced") == 1

    calls = []
    real = torch.profiler.record_function

    def spy(name):
        calls.append(name)
        return real(name)

    torch.profiler.record_function = spy
    try:
        with profiling.span("test.span.untraced"):
            pass
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        with profiling.span("test.span.started"):
            pass
        prof.stop()
    finally:
        torch.profiler.record_function = real
    assert calls == ["test.span.started"]
    assert profiling.snapshot()["test.span.untraced"][0] >= 1


@pytest.fixture
def mark_log(monkeypatch):
    """The regions marked, in order; the library load raises, so a mark
    that tried to launch on the CPU would fail the test."""
    log = []
    real = marks.mark

    def spy(region, like):
        log.append(region)
        real(region, like)

    def no_library():
        raise AssertionError("a CPU mark loaded the marks' library")

    monkeypatch.setattr(marks, "mark", spy)
    monkeypatch.setattr(marks.MARK, "load", no_library)
    return log


def test_mark_is_a_no_op_on_the_cpu(mark_log):
    x = torch.zeros(3, dtype=torch.int32)
    for region in marks.REGIONS:
        assert marks.mark(region, x) is None
    assert mark_log == list(marks.REGIONS)
    with pytest.raises(KeyError):
        marks.mark("nowhere", x)


def _golden(vectors, codec, soft):
    vec = vectors(f"e2e_{codec}_soft" if soft else f"e2e_{codec}")
    frames = torch.from_numpy(vec["frames"])
    rel = torch.from_numpy(vec["rel"]) if soft else None
    state = st.init_state(frames.shape[1], rng_seed=vec["seeds"],
                          carry_enh=codec.startswith("ambe"), device="cpu")
    return frames, rel, state


def _compiled_run(codec, soft, frames, rel, state, steps):
    compiled = pipeline.CompiledStep(codec, state, soft=soft, int16=True)
    out = []
    for t in range(steps):
        _, audio, res = compiled(frames[t], None if rel is None else rel[t])
        out.append((audio.clone(), compiled.words.clone(), compiled.dbits.clone()))
    return out + [tuple(x.clone() for x in graphs.leaves(compiled.state))]


@pytest.mark.parametrize("codec,soft", [("imbe7200", False), ("imbe7100", True),
                                        ("ambe2450", True), ("ambe2400", False)])
def test_compiled_step_marks_in_order_and_outputs_unchanged(vectors, mark_log, monkeypatch,
                                                            codec, soft):
    """CompiledStep's body marks each step bit_domain, fsm, synthesis (AMBE:
    fsm again for its state commits), commit, end: at most 8. Its PCM,
    words, parameter bits and state are bit-identical to a run whose marks
    are no calls at all."""
    steps = 3
    frames, rel, state = _golden(vectors, codec, soft)
    marked = _compiled_run(codec, soft, frames, rel, state, steps)
    per_step = (AMBE_STEP if codec.startswith("ambe") else IMBE_STEP) + ["end"]
    assert len(per_step) <= 8
    assert mark_log == per_step * steps

    monkeypatch.setattr(marks, "mark", lambda region, like: None)
    frames, rel, state = _golden(vectors, codec, soft)
    plain = _compiled_run(codec, soft, frames, rel, state, steps)
    for a, b in zip(marked, plain):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("codec", ["imbe7200", "ambe2450"])
def test_step_and_stream_outputs_unchanged_by_marks(vectors, mark_log, monkeypatch, codec):
    """pipeline.step over a whole e2e golden and StreamingDecoder over its
    frames: bit-identical with and without the marks' calls; a streaming
    tick marks bit_domain before its unpack, then the step's regions and
    end after the bundle."""
    frames, _, state = _golden(vectors, codec, False)
    seeds = vectors(f"e2e_{codec}")["seeds"]
    n = frames.shape[0]

    def run():
        s = state
        steps = []
        for t in range(n):
            s, audio, res, d = pipeline.step(codec, frames[t], s)
            steps.append((audio, *res.values(), d))
        dec = StreamingDecoder(codec, frames.shape[1], rng_seed=seeds, depth=2, device="cpu")
        ticks = [p for t in range(n) for p in dec.push(frames[t].numpy())] + list(dec.flush())
        return steps, ticks

    steps, ticks = run()
    step_marks = AMBE_STEP if codec.startswith("ambe") else IMBE_STEP
    assert mark_log == step_marks * n + (["bit_domain"] + step_marks + ["end"]) * n
    monkeypatch.setattr(marks, "mark", lambda region, like: None)
    steps0, ticks0 = run()
    for a, b in zip(steps, steps0):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert len(ticks) == len(ticks0) == n
    for (pcm, res), (pcm0, res0) in zip(ticks, ticks0):
        np.testing.assert_array_equal(pcm, pcm0)
        for k in res:
            np.testing.assert_array_equal(res[k], res0[k])


def test_stream_spans_count_one_per_tick():
    """Each mbe.stream.* span advances by one per tick pushed and read back
    (on the CPU too, where the tick runs eagerly and replays no graph)."""
    names = ("mbe.stream.stage", "mbe.stream.wait", "mbe.stream.copy_out")
    before = profiling.snapshot()
    dec = StreamingDecoder("imbe7200", 4, rng_seed=np.arange(1, 5, dtype=np.uint32),
                           depth=1, device="cpu")
    rng = np.random.default_rng(5)
    ticks = 5
    got = [p for _ in range(ticks) for p in dec.push(rng.integers(0, 256, (4, 23), np.uint8))]
    got += list(dec.flush())
    after = profiling.snapshot()
    assert len(got) == ticks
    for name in names:
        assert after[name][0] - before.get(name, (0, 0))[0] == ticks, name
    assert after.get("mbe.graph.replay") == before.get("mbe.graph.replay")
