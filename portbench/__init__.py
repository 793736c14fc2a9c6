"""The benchmark of mbe_tpu_torch on one NVIDIA H100 (see BENCHMARK.json at
the repository root and PERF.md). `run.py` is the command."""
