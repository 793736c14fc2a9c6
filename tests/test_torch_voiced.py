"""The voiced oscillator bank (kernel B1, ops/cuda/voiced.py) on the CPU: a
numpy float32 emulation of the CUDA kernel's arithmetic (csrc/voiced.cu),
in its order, against the plain version.

The kernel seeds each (channel, harmonic) once with sincos of phi and of
the step s, walks g*e^{i phi} to every 16-sample span by the rotor
(cos 16s, sin 16s) built by four squarings, runs the Chebyshev recurrence
within each span, the interpolated path by a double rotor seeded per span,
and folds the windows in per bank. These tests are the proof, before the
card sees the kernel, that 16-sample spans hold the 2e-4 gate, small-s
lanes included (the recurrence's sensitivity to the rounding of 2cos(s)
grows as n^2/2 as s -> 0).
"""

import numpy as np
import pytest
import torch

from mbe_tpu_torch.ops.cuda import voiced

torch.set_num_threads(1)

TOL = 2e-4  # of max |ref|: the recurrence drift bound of the TPU kernel
F = np.float32
SPAN = 16
SPANS = 160 // SPAN


def _inputs(c, seed):
    """voiced_sums inputs in the ranges of chip_smoke.kernel_inputs."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(F)

    return [u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
            u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
            u(0, 4, (7, c)), u(-0.02, 0.02, (7, c)), u(0, 6, (7, c)),
            u(0, 2, (7, c)), u(-2e-3, 2e-3, (7, c)), u(0, 1, 160), u(0, 1, 160)]


def _rotate(re, im, br, bi):
    return re * br - im * bi, re * bi + im * br


def _bank(g, phi, s):
    """One bank's per-span sums [SPANS, SPAN, C] as the kernel forms them:
    seeds once per (harmonic, channel), span starts by the squared rotor,
    then 16 Chebyshev steps per span, harmonics summed in ascending order."""
    cs, ss = np.cos(s), np.sin(s)
    rr, ri = cs, ss
    for _ in range(4):
        rr, ri = rr * rr - ri * ri, F(2) * rr * ri
    zr, zi = g * np.cos(phi), g * np.sin(phi)
    t0 = np.empty((SPANS,) + g.shape, F)
    t1 = np.empty_like(t0)
    for j in range(SPANS):
        t0[j] = zr
        t1[j] = zr * cs - zi * ss
        zr, zi = _rotate(zr, zi, rr, ri)
    c2 = F(2) * cs
    out = np.zeros((SPANS, SPAN, g.shape[1]), F)
    for l in range(g.shape[0]):
        a, b = t0[:, l], t1[:, l]
        out[:, 0] += a
        out[:, 1] += b
        for k in range(2, SPAN):
            a, b = b, c2[l] * b - a
            out[:, k] += b
    return out


def _kernel_emulation(g_p, phi_p, s_p, g_c, phi_c, s_c, a0, da, phi0, alpha, q, w_p, w_c):
    """csrc/voiced.cu's arithmetic in numpy float32, [160, C]."""
    win = lambda w: w.reshape(SPANS, SPAN)[:, :, None]  # noqa: E731
    acc = win(w_p) * _bank(g_p, phi_p, s_p)
    acc = acc + win(w_c) * _bank(g_c, phi_c, s_c)
    n0 = (np.arange(SPANS) * SPAN).astype(F)[:, None]  # [SPANS, 1]
    for l in range(a0.shape[0]):
        theta = phi0[l] + alpha[l] * n0 + q[l] * n0 * n0
        delta = alpha[l] + q[l] * (F(2) * n0 + F(1))
        oc, os_ = np.cos(theta), np.sin(theta)
        dc, ds = np.cos(delta), np.sin(delta)
        rc, rs = np.cos(F(2) * q[l]), np.sin(F(2) * q[l])
        for k in range(SPAN):
            acc[:, k] += (a0[l] + (n0 + F(k)) * da[l]) * oc
            oc, os_ = _rotate(oc, os_, dc, ds)
            dc, ds = _rotate(dc, ds, rc, rs)
    return acc.reshape(160, -1)


def _plain(args):
    return voiced.voiced_sums_reference(*map(torch.from_numpy, args)).numpy()


def test_kernel_arithmetic_matches_plain():
    """The emulated kernel at a ragged C = 200 (six full blocks of 32 and a
    partial one) against the plain version: within 2e-4 of max |ref|."""
    args = _inputs(200, 3)
    got, want = _kernel_emulation(*args), _plain(args)
    assert got.shape == (160, 200)
    assert np.abs(got - want).max() / np.abs(want).max() < TOL


@pytest.mark.parametrize("s", [1e-4, 1e-3, np.pi - 1e-3, 3.0],
                         ids=["s1e-4", "s1e-3", "pi-1e-3", "s3"])
def test_kernel_arithmetic_edge_lanes(s):
    """Lanes whose every harmonic step is s in both banks (the small-s
    lanes are where 2cos(s) rounds to within an ulp of 2), with phases
    near 6 rad: the emulated kernel against the plain version within 2e-4
    of those lanes' own max |ref|, over the whole frame and over the last
    span (n0 = 144, where the seed has been rotated nine times)."""
    args = _inputs(64, 11)
    rng = np.random.default_rng(5)
    edge = slice(0, 16)
    for i in (2, 5):                   # the two banks' steps
        args[i][:, edge] = F(s)
    for i in (1, 4, 8):                # bank and interpolated start phases
        args[i][:, edge] = rng.uniform(6 - 1e-3, 6, args[i][:, edge].shape).astype(F)
    got, want = _kernel_emulation(*args)[:, edge], _plain(args)[:, edge]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < TOL
    assert np.abs(got[-SPAN:] - want[-SPAN:]).max() / scale < TOL
