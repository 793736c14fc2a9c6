"""The port's profiling helpers (mbe_tpu_torch.utils.profiling) on the
CPU: the slope of a body of known cost, the host readback and the trace
file. The card's graphed device_time (a bf16 matmul against its peak) is
in tests/test_torch_cuda.py and chip_smoke.py phase 8."""

import torch

from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.utils import profiling


def test_device_time_reads_a_known_cost(monkeypatch):
    """On a fake clock that each body call advances by 2 ms and each
    readback (`force`) by 20 ms, the slope reads 2 ms (the per-run
    constant cancels); the carry passes through and carry0 is left as it
    was."""
    now_ms = [0]
    real_force = profiling.force

    def body(c):
        now_ms[0] += 2
        return c + 1

    def force(tree):
        now_ms[0] += 20
        return real_force(tree)

    monkeypatch.setattr(profiling.time, "perf_counter", lambda: now_ms[0] / 1000)
    monkeypatch.setattr(profiling, "force", force)
    carry0 = torch.zeros(4)
    sec = profiling.device_time(body, carry0, iters=20, short_iters=5, reps=3)
    assert abs(sec - 0.002) < 1e-12, sec
    assert torch.equal(carry0, torch.zeros(4))


def test_device_time_carries_a_state_tree():
    """A ChannelState carry (a dataclass tree) goes through the loop leaf
    for leaf."""
    seen = []

    def body(state):
        seen.append(state)
        return st.map_state(lambda x: x + 1, state)

    state = st.init_state(3, device="cpu")
    assert profiling.device_time(body, state, iters=4, short_iters=2, reps=1) >= 0.0
    assert torch.equal(seen[1].lcg_prime, state.lcg_prime + 1)


def test_force_returns_a_host_value():
    out = profiling.force((torch.arange(6).reshape(2, 3) + 7, None))
    assert isinstance(out, int) and out == 7
    assert profiling.force({"a": torch.tensor(3.5)}) == 3.5
    assert profiling.force(torch.ones(2, dtype=torch.bfloat16)) == 1.0


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(tmp_path / "t") as prof:
        torch.ones(64).cumsum(0)
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert any("cumsum" in e.name for e in prof.events())
