"""Lane select of the FSM's state: the hand-written CUDA kernel
(csrc/select.cu), one launch per call.

lane_select(selects) writes up to MAX_OUTPUTS outputs. `selects` holds
one (cases, default) per output; `cases` is up to MAX_CASES (mask, source)
pairs, each mask a [C] bool tensor. A source, like a default, is a list
of the same number of leaves (at most MAX_LEAVES), each a [C] or [rows, C]
tensor of float32, int32 or int64, or a Python number: a constant leaf,
written from an immediate. A case's source may instead be an int j below
the output's own index: output j of the same call, which the kernel
resolves per lane to the source output j chose there (it never reads an
output back). Output i's leaf k is, per lane, leaf k of the source of the
first case whose mask is set, else of the default. The outputs are lists
of tensors: a leaf whose every source is one tensor is that tensor, as
in the plain form; every other leaf is a new tensor, written once.

models/state.py holds the one dispatch (select_many: these for CUDA
tensors, its plain form select_many_reference for any other), whose
outputs equal the plain form's bit for bit. `pack` checks every argument
(dtype, shape, contiguity, one device, the counts) and builds the
kernel's argument struct; `lane_select` raises for any device but CUDA
and launches nothing when there is nothing to write.
"""

import ctypes

import numpy as np
import torch

from . import build

MAX_OUTPUTS = 3
MAX_CASES = 3
SOURCES = MAX_CASES + 1          # the cases in order, then the default
MAX_LEAVES = 21                  # a Parms
MAX_SEGMENTS = MAX_OUTPUTS * MAX_LEAVES
TENSOR, CONSTANT, OUTPUT = 0, 1, 2
DTYPES = (torch.float32, torch.int32, torch.int64)

# rows of the flattened (output, leaf, row) space per thread: 2 for a
# one-output select, 4 for more (the best of 1 to 16 for each call of an
# IMBE and an AMBE step on the card, within 2%: PERF.md, the kernel table)
SPAN_ONE, SPAN_MANY = 2, 4

class Args(ctypes.Structure):
    """The kernel's argument struct (csrc/select.cu `Args`), passed by
    value: src[o][j][k] is a pointer, a constant's bits or an output's
    index by kind[o][j][k] (source j: the cases, then the default);
    out[o][k] is null for a leaf not written; segment s covers rows
    seg_start[s] .. seg_start[s + 1] of the flattened space, leaf
    seg_leaf[s] of output seg_out[s]."""

    _fields_ = [
        ("src", ctypes.c_int64 * MAX_LEAVES * SOURCES * MAX_OUTPUTS),
        ("out", ctypes.c_void_p * MAX_LEAVES * MAX_OUTPUTS),
        ("mask", ctypes.c_void_p * MAX_CASES * MAX_OUTPUTS),
        ("kind", ctypes.c_uint8 * MAX_LEAVES * SOURCES * MAX_OUTPUTS),
        ("n_cases", ctypes.c_int32 * MAX_OUTPUTS),
        ("leaf_bytes", ctypes.c_int32 * MAX_LEAVES),
        ("seg_start", ctypes.c_int32 * (MAX_SEGMENTS + 1)),
        ("seg_out", ctypes.c_uint8 * MAX_SEGMENTS),
        ("seg_leaf", ctypes.c_uint8 * MAX_SEGMENTS),
        ("n_outputs", ctypes.c_int32),
        ("n_segments", ctypes.c_int32),
        ("rows", ctypes.c_int32),
        ("c", ctypes.c_int32),
        ("span", ctypes.c_int32),
    ]


def _check_layout(lib):
    """The C struct's size and field offsets must be those of `Args`."""
    lib.mbe_lane_select_layout.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.mbe_lane_select_layout.restype = ctypes.c_int
    layout = (ctypes.c_int64 * (len(Args._fields_) + 1))()
    n = lib.mbe_lane_select_layout(layout)
    want = [ctypes.sizeof(Args)] + [getattr(Args, f).offset for f, _ in Args._fields_]
    if list(layout[:n]) != want:
        raise RuntimeError(f"lane_select: the C argument layout {list(layout[:n])} is not "
                           f"the binding's {want}")


KERNEL = build.register(build.Kernel("lane_select", build.CSRC / "select.cu", "mbe_lane_select",
                                     [ctypes.POINTER(Args), build.INT, build.PTR],
                                     _check_layout))


def _constant_bits(v, dtype):
    """The bits of constant v in a leaf of `dtype`, as a signed 64-bit int
    (a float32's bits, an int32 sign-extended, an int64 as it is)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"lane_select: a constant leaf must be an int or a float, got {v!r}")
    if dtype == torch.float32:
        return int(np.float32(v).view(np.int32))
    if isinstance(v, float):
        raise ValueError(f"lane_select: float constant {v!r} for an {dtype} leaf")
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    if not info.min <= v <= info.max:
        raise ValueError(f"lane_select: constant {v} out of range for {dtype}")
    return v


def _leaf_layouts(selects, c):
    """The shape and dtype of each leaf, from the first tensor that gives
    it; and (name, tensor, dtype, shape) of every mask, then every tensor
    leaf, for build.check."""
    n = len(selects[0][1])
    layouts = [None] * n
    tensors = [("a mask", m, torch.bool, (c,)) for cases, _ in selects for m, _ in cases]
    for cases, default in selects:
        for src in [t for _, t in cases if not isinstance(t, int)] + [default]:
            if len(src) != n:
                raise ValueError(f"lane_select: a source has {len(src)} leaves, not {n}")
            for k, x in enumerate(src):
                if not isinstance(x, torch.Tensor):
                    continue
                if layouts[k] is None:
                    if x.dtype not in DTYPES:
                        raise ValueError(f"lane_select: leaf {k} is {x.dtype}, not one of "
                                         f"{DTYPES}")
                    if x.dim() not in (1, 2) or x.shape[-1] != c:
                        raise ValueError(f"lane_select: leaf {k} has shape {tuple(x.shape)}, "
                                         f"not (C,) or (rows, C) with C = {c}")
                    layouts[k] = (tuple(x.shape), x.dtype)
                tensors.append((f"leaf {k}", x, layouts[k][1], layouts[k][0]))
    for k, layout in enumerate(layouts):
        if layout is None:
            raise ValueError(f"lane_select: leaf {k} is a constant in every source")
    return layouts, tensors


def pack(selects):
    """Check `selects` (see the module docstring) and build the launch:
    (args, vec, outputs). args is the filled `Args`; vec whether the
    16-byte form applies (C % 4 == 0 and every pointer 16-byte aligned);
    outputs the lists of leaves to return, new leaves allocated with
    torch.empty on the masks' device (the launch writes them)."""
    if not 1 <= len(selects) <= MAX_OUTPUTS:
        raise ValueError(f"lane_select: 1 to {MAX_OUTPUTS} outputs, got {len(selects)}")
    for i, (cases, _) in enumerate(selects):
        if not 1 <= len(cases) <= MAX_CASES:
            raise ValueError(f"lane_select: output {i} has {len(cases)} cases, not 1 to "
                             f"{MAX_CASES}")
        for _, t in cases:
            if isinstance(t, int) and not 0 <= t < i:
                raise ValueError(f"lane_select: output {i} names output {t} as a source; "
                                 f"only an earlier output of the call can be one")
    n = len(selects[0][1])
    if not 1 <= n <= MAX_LEAVES:
        raise ValueError(f"lane_select: 1 to {MAX_LEAVES} leaves, got {n}")
    mask0 = selects[0][0][0][0]
    c = mask0.shape[-1] if mask0.dim() == 1 else -1
    layouts, tensors = _leaf_layouts(selects, c)
    device = build.check("lane_select", tensors)

    args = Args()
    outputs, written, segments = [], [], []
    aligned = c % 4 == 0
    for k, (_, dtype) in enumerate(layouts):
        args.leaf_bytes[k] = dtype.itemsize
    for o, (cases, default) in enumerate(selects):
        args.n_cases[o] = len(cases)
        for j, (m, _) in enumerate(cases):
            args.mask[o][j] = m.data_ptr()
            aligned &= m.data_ptr() % 16 == 0
        sources = [t for _, t in cases] + [default]
        out, wrote = [], []
        for k, (shape, dtype) in enumerate(layouts):
            # per source: a tensor or a constant, or (OUTPUT, p) for a leaf
            # that output p writes in this launch
            cands = [t[k] if not isinstance(t, int)
                     else (OUTPUT, t) if written[t][k] else outputs[t][k] for t in sources]
            if all(x is cands[0] for x in cands) and isinstance(cands[0], torch.Tensor):
                out.append(cands[0])    # one tensor on every lane: no copy
                wrote.append(False)
                continue
            for j, x in enumerate(cands):
                if isinstance(x, tuple):
                    args.kind[o][j][k], args.src[o][j][k] = x
                elif isinstance(x, torch.Tensor):
                    args.kind[o][j][k], args.src[o][j][k] = TENSOR, x.data_ptr()
                    aligned &= x.data_ptr() % 16 == 0
                else:
                    args.kind[o][j][k], args.src[o][j][k] = CONSTANT, _constant_bits(x, dtype)
            y = torch.empty(shape, dtype=dtype, device=device)
            args.out[o][k] = y.data_ptr()
            aligned &= y.data_ptr() % 16 == 0
            out.append(y)
            wrote.append(True)
            segments.append((o, k, shape[0] if len(shape) == 2 else 1))
        outputs.append(out)
        written.append(wrote)
    args.n_outputs = len(selects)
    args.n_segments = len(segments)
    start = 0
    for s, (o, k, rows) in enumerate(segments):
        args.seg_start[s], args.seg_out[s], args.seg_leaf[s] = start, o, k
        start += rows
    args.seg_start[len(segments)] = start
    args.rows, args.c = start, c
    args.span = SPAN_ONE if len(selects) == 1 else SPAN_MANY
    return args, aligned, outputs


def lane_select(selects):
    """The outputs of `selects` (see the module docstring), one launch on
    the current stream of the masks' CUDA device."""
    args, vec, outputs = pack(selects)
    if args.rows > 0 and args.c > 0:
        KERNEL.launch(selects[0][0][0][0].device, args, int(vec))
    else:
        KERNEL.gate(selects[0][0][0][0].device)
    return outputs
