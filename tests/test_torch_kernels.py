"""The kernel registry (mbe_tpu_torch/ops/cuda/build.py) on the CPU: every
source under csrc/ is registered, each entry point's ctypes parameters
are those of its C declaration, every binding raises off CUDA after its
checks and counts nothing, utils/graphs reads the registry's counts, and
no binding calls a plain form (the caller chooses). The launches
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import ast
import contextlib
import ctypes
import inspect
import re
import types

import pytest
import torch

import mbe_tpu_torch  # noqa: F401  (registers every kernel)
from mbe_tpu_torch.ops import noise, synth
from mbe_tpu_torch.ops.cuda import build, marks, select, softecc, sources, unvoiced, voiced
from mbe_tpu_torch.utils import graphs

C = 8
COUNTED = [k.symbol for k in build.KERNELS if k.counter is not None]


def _call(symbol, device, c=C):
    """A well-formed call of the binding of `symbol` at c channels on
    `device`."""
    i32, i64 = torch.int32, torch.int64

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if symbol == "mbe_voiced_sums":
        return voiced.voiced_sums(*[z(56, c)] * 6, *[z(7, c)] * 5, z(160), z(160))
    if symbol == "mbe_soft_decode_keys":
        return softecc.soft_decode_keys(z(c, 23, dtype=i32), z(c, 23, dtype=i32),
                                        z(c, dtype=i32), "golay")
    if symbol == "mbe_unvoiced_wola":
        return unvoiced.unvoiced_wola(z(c), z(c, dtype=i32), z(57, c), z(57, c, dtype=i32),
                                      z(128, c), z(256, c))
    if symbol == "mbe_comfort_noise":
        return sources.comfort_noise(z(3, c, dtype=i64), 160,
                                     *(t.to(device) for t in noise._java_jumps("cpu")),
                                     noise.COMFORT_GAIN)
    if symbol == "mbe_lcg_buffer":
        return sources.lcg_buffer(z(c), z(c), z(c),
                                  *(t.to(device) for t in noise._lcg_tables("cpu")))
    if symbol == "mbe_tone_render":
        return sources.render_tone(z(c, dtype=i32), z(c, dtype=i32), z(c, dtype=i64),
                                   z(c, dtype=i64),
                                   [t.to(device) for t in synth._tone_tables("cpu")],
                                   synth.SOFT_CLIP, synth.TONE_RAD, synth.HALF_PI)
    if symbol == "mbe_lane_select":
        return select.lane_select([([(z(c, dtype=torch.bool), [z(c)])], [z(c) + 1])])
    raise AssertionError(f"no call of {symbol}")


def _c_parameters(kernel):
    """The kinds ("ptr", "int", "float") of the parameters of the C
    declaration of `kernel.symbol` in its source."""
    text = kernel.source.read_text()
    found = re.search(rf'extern "C" int {kernel.symbol}\((.*?)\)', text, re.S)
    assert found, f"{kernel.symbol} is not declared in {kernel.source.name}"
    return ["ptr" if "*" in p else "float" if p.split()[0] == "float" else "int"
            for p in found.group(1).split(",")]


def _kind(argtype):
    if argtype is ctypes.c_int:
        return "int"
    if argtype is ctypes.c_float:
        return "float"
    assert argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer), argtype
    return "ptr"


def test_registry_names_the_sources_and_their_counts():
    """Every source under csrc/ has an entry point in the registry and
    nothing else does; the five kernel libraries have one count each (the
    marks none); and the entry points of B1-B3 take 14 pointers and 1 int,
    6 and 2, and 13 and 1, then the stream. Every counted entry point has
    a call in this file."""
    assert {k.source for k in build.KERNELS} == set(build.CSRC.glob("*.cu"))
    assert set(build.LAUNCHES) == {"voiced_sums", "soft_decode", "unvoiced_wola", "sources",
                                   "lane_select"}
    assert [k.counter for k in build.KERNELS if k.source.name == "marks.cu"] == [None]
    by_symbol = {k.symbol: [_kind(a) for a in k.argtypes] for k in build.KERNELS}
    for symbol, pointers, ints in (("mbe_voiced_sums", 14, 1), ("mbe_soft_decode_keys", 6, 2),
                                   ("mbe_unvoiced_wola", 13, 1)):
        assert by_symbol[symbol] == ["ptr"] * pointers + ["int"] * ints + ["ptr"], symbol
    assert set(COUNTED) == {"mbe_voiced_sums", "mbe_soft_decode_keys", "mbe_unvoiced_wola",
                            "mbe_comfort_noise", "mbe_lcg_buffer", "mbe_tone_render",
                            "mbe_lane_select"}


@pytest.mark.parametrize("kernel", build.KERNELS, ids=lambda k: k.symbol)
def test_argtypes_match_the_c_declaration(kernel):
    """The ctypes parameters of each entry point, one by one, are the kinds
    of its C declaration's, the stream (a pointer) last."""
    assert [_kind(a) for a in kernel.argtypes] == _c_parameters(kernel)
    assert _kind(kernel.argtypes[-1]) == "ptr"


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("symbol", COUNTED)
def test_entry_point_raises_off_cuda(symbol, device):
    """Each binding launches on CUDA tensors alone: well-formed inputs on
    another device pass the checks, then raise, and nothing is counted."""
    counter = next(k.counter for k in build.KERNELS if k.symbol == symbol)
    before = build.LAUNCHES[counter].n
    with pytest.raises(ValueError, match=f"{symbol}: no kernel for device {device}"):
        _call(symbol, device)
    assert build.LAUNCHES[counter].n == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("symbol", COUNTED)
def test_empty_call_raises_off_cuda(symbol, device):
    """With no channels a binding may launch nothing (sources, lane_select),
    but off CUDA it raises all the same, and nothing is counted."""
    before = build.counts()
    with pytest.raises(ValueError, match=f"{symbol}: no kernel for device {device}"):
        _call(symbol, device, 0)
    assert build.counts() == before


@pytest.mark.parametrize("counter", sorted(build.LAUNCHES))
def test_graphs_carry_the_registry_counts(counter, monkeypatch):
    """utils/graphs.Captured reads the registry's counts, with no list of
    kernels of its own: the launches counted during a capture are taken
    back and added on every replay, a count first made during the capture
    counts from 0, and no other count moves. Recorded on stand-ins for the
    CUDA calls (the capture itself needs a card)."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    for name, fake in (("device", lambda d: contextlib.nullcontext()),
                       ("Stream", lambda: stream), ("current_stream", lambda d=None: stream),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("graph", lambda g, stream=None: contextlib.nullcontext()),
                       ("CUDAGraph", lambda: types.SimpleNamespace(replay=lambda: None))):
        monkeypatch.setattr(torch.cuda, name, fake)
    assert graphs.LAUNCHES is build.LAUNCHES and not hasattr(graphs, "KERNELS")
    registry = dict(build.LAUNCHES)
    monkeypatch.setattr(graphs, "LAUNCHES", registry)
    count, late = registry[counter], build.Count()
    monkeypatch.setattr(count, "n", 5)
    others = {name: c.n for name, c in registry.items() if c is not count}

    def fn():
        count.n += 3
        registry["late"] = late
        late.n += 2

    graph = graphs.Captured(fn, "cuda:0", warmup=lambda: None)
    assert (count.n, late.n) == (5, 0)
    graph.replay()
    graph.replay()
    assert (count.n, late.n) == (11, 4)
    assert {name: c.n for name, c in registry.items() if c not in (count, late)} == others


@pytest.mark.parametrize("module", [voiced, softecc, unvoiced, sources, select, marks],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_binding_calls_no_plain_form(module):
    """The bindings launch only: none calls a `*_reference` plain form or
    imports ops/noise.py or ops/synth.py (which import the bindings); the
    one caller of each kernel chooses between the two."""
    tree = ast.parse(inspect.getsource(module))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
    assert not {n for n in names if "noise" in n or "synth" in n}, names
    called = {node.func.attr if isinstance(node.func, ast.Attribute) else node.func.id
              for node in ast.walk(tree) if isinstance(node, ast.Call)
              and isinstance(node.func, (ast.Attribute, ast.Name))}
    assert not {n for n in called if n.endswith("_reference")}, called
