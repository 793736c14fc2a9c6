"""examples/decode_stream_torch.py, the port of examples/decode_stream.py,
on the CPU: its three lines equal the JAX example's on the same seeded
frames (per-frame step, run_sequence, packed-byte streaming)."""

import importlib.util
from pathlib import Path

import torch

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "decode_stream_torch.py"

# examples/decode_stream.py's output (mbe_tpu on the CPU)
JAX_LINES = ["frame 0, channel 0: total_errors=8 trace='========R' pcm rms=0.0",
             "scan: pcm (20, 64, 160), mean errors/frame=8.77",
             "streaming: 20 PCM blocks of shape (C=64, 160)"]


def test_example_prints_the_jax_example_lines(capsys):
    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location("decode_stream_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == JAX_LINES
