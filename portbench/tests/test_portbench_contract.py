"""The benchmark's own rules: what it may import, that every name in
BENCHMARK.json has its file, and the kernels' least work."""

import ast
import json
import math
from pathlib import Path

import pytest

from portbench.kernels import b1, b2, b3, peaks

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "mbe_tpu"}


def imported_top_names(path):
    """Top-level names of every module `path` imports (absolute imports;
    relative ones stay inside the package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax_anywhere(path):
    """No module of the benchmark imports jax, jaxlib, flax or mbe_tpu
    (whole top-level names: mbe_tpu_torch is the program and allowed)."""
    assert not imported_top_names(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert "mbe_tpu_torch" not in imported_top_names(path), path
        assert "portbench" not in imported_top_names(path), path


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file(), c["file"]
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "entries" / f"{traffic['entry']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_layers_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]


def test_bounds_at_full_width():
    """The kernels' least times at C = 32768: B1 0.0576 ms, B2 0.0532 ms
    at the soft imbe7200 step's launch shapes, B3 0.0308 ms."""
    ms = [1e3 * peaks.bound_s(**w) for w in
          (b1.work(32768), b2.work("imbe7200", 32768), b3.work(32768))]
    for got, want in zip(ms, (0.0576, 0.0532, 0.0308)):
        assert math.isclose(got, want, rel_tol=5e-3), (got, want)
    # B1's 58,860 FP32 ops per channel; B2's 52.6 GFLOP per soft imbe7200 step
    assert b1.work(1)["fp32_ops"] == 58860
    assert math.isclose(b2.work("imbe7200", 32768)["bf16_flops"], 52.6e9, rel_tol=2e-3)
