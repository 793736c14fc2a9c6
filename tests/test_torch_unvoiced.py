"""The unvoiced stage (kernel B3, ops/cuda/unvoiced.py) on the CPU: its
plain version against the JAX Pallas kernel (interpret mode) and the JAX
XLA stage, a numpy emulation of the CUDA kernel's arithmetic against the
plain version, and the caller's dispatch and the kernel entry's input
checks."""

import numpy as np
import pytest
import torch

from mbe_tpu.ops import synth as jsynth
from mbe_tpu_torch.ops import synth
from mbe_tpu_torch.ops.cuda import build, unvoiced

torch.set_num_threads(1)

TOL = 1e-4  # of max |ref|: DFT sum order (the JAX kernel's bf16 hi/lo split ~90 dB)


def _inputs(c, seed):
    """Random unvoiced-stage inputs in the ranges of tests/test_pallas.py:
    L 9..56 with w0 from L; an eighth of the lanes at w0 = 0 (the AMBE
    erasure model) and an eighth at L = 56."""
    rng = np.random.default_rng(seed)
    L = rng.integers(9, 57, c).astype(np.int32)
    L[c // 8: c // 4] = 56
    w0 = (2.0 * np.pi * 0.4875 / (L + 0.25)).astype(np.float32)
    w0[: c // 8] = 0.0
    return (w0, L, rng.uniform(0, 500, (57, c)).astype(np.float32),
            rng.integers(0, 2, (57, c)).astype(np.int32),
            rng.uniform(-400, 400, (128, c)).astype(np.float32),
            rng.uniform(0, 53125, (256, c)).astype(np.float32))


def _rel_err(got, want):
    scale = max(np.abs(w).max() for w in want)
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / scale


@pytest.mark.parametrize("pallas", ["1", "0"], ids=["pallas_interpret", "xla"])
def test_plain_matches_jax(monkeypatch, pallas):
    """unvoiced_wola_reference against JAX synth.unvoiced_fft through the
    Pallas kernel in interpret mode (MBE_TPU_PALLAS_UNVOICED=1) and through
    the XLA form (=0), C = 128: add and the new previousUw within 1e-4 of
    max |ref|; the w0 = 0 lanes give exactly zero new Uw."""
    args = _inputs(128, 5)
    monkeypatch.setenv("MBE_TPU_PALLAS_UNVOICED", pallas)
    want = [np.asarray(x) for x in jsynth.unvoiced_fft(*args)]
    got = [x.numpy() for x in unvoiced.unvoiced_wola_reference(*map(torch.from_numpy, args))]
    assert _rel_err(got, want) < TOL
    np.testing.assert_array_equal(got[1][:, :16], 0.0)


F = np.float32
BITREV7 = np.array([int(f"{k:07b}"[::-1], 2) for k in range(128)])


def _twiddle(tab, idx, sign):
    """e^{sign 2 pi i idx / 256} from the cosine table (sin x = cos(x - pi/2))."""
    idx = np.asarray(idx)
    return tab[idx & 255], F(sign) * tab[(idx + 192) & 255]


def _fft_stage(re, im, tab, h, dif):
    """One radix-2 stage of half-size h on [128, C] complex elements, as
    csrc/unvoiced.cu's fft_group does it: decimation in frequency with
    forward twiddles, or in time with inverse ones."""
    c = re.shape[1]
    shape = (128 // (2 * h), 2, h, c)
    re, im = re.reshape(shape), im.reshape(shape)
    wr, wi = _twiddle(tab, np.arange(h) * (128 // h), -1 if dif else 1)
    wr, wi = wr[:, None], wi[:, None]
    ur, ui, xr, xi = re[:, 0], im[:, 0], re[:, 1], im[:, 1]
    if dif:
        vr, vi = ur - xr, ui - xi
        out = (ur + xr, ui + xi, vr * wr - vi * wi, vr * wi + vi * wr)
    else:
        vr, vi = xr * wr - xi * wi, xr * wi + xi * wr
        out = (ur + vr, ui + vi, ur - vr, ui - vi)
    re = np.stack([out[0], out[2]], axis=1).reshape(128, c)
    im = np.stack([out[1], out[3]], axis=1).reshape(128, c)
    return re, im


def _split_bin(tab, k, zr, zi, pr, pi):
    ar, ai = F(0.5) * (zr + pr), F(0.5) * (zi - pi)
    br, bi = F(0.5) * (zr - pr), F(0.5) * (zi + pi)
    wr, wi = _twiddle(tab, k, -1)
    tr, ti = wr * br - wi * bi, wr * bi + wi * br
    return ar + ti, ai - tr


def _pack_bin(tab, k, yr, yi, pr, pi):
    qr, qi = yr - pr, yi + pi
    vr, vi = _twiddle(tab, k, 1)
    ur, ui = vr * qr - vi * qi, vr * qi + vi * qr
    return (yr + pr) - ui, (yi - pi) + ur


def _band_ids(m):
    """band_of_bin of bins 0..127 ([128, C], 57 = no band), two correction rounds."""
    kf = np.arange(128, dtype=F)[:, None]
    safe = m > 0
    band = np.floor(kf / np.where(safe, m, F(1)) + F(0.5))
    for _ in range(2):
        lo = np.ceil((band - F(0.5)) * m)
        hi = np.ceil((band + F(0.5)) * m)
        band = band + (kf >= hi) - (kf < lo)
    return np.where(safe & (band >= 0) & (band <= 56), band, 57).astype(np.int64)


def _kernel_emulation(w0, L, Ml, Vl, prev, noise):
    """The arithmetic of csrc/unvoiced.cu in numpy float32: the 128-point
    complex FFT of z[m] = x[2m] + i x[2m+1] by radix-2 DIF stages with
    twiddles from the 256-entry cosine table, the split into bins 0..127,
    band energies per (band, channel) over bins a_min..b_max-1 in
    ascending order, band ids of bins 0..127 with two correction rounds,
    band 57 as the zero row, the Hermitian pack of the scaled half
    spectrum, the inverse FFT by radix-2 DIT stages, and the WOLA by the
    reciprocal of its denominator."""
    win256, w_prev, w_curr, denom = (x.numpy()[:, 0] for x in unvoiced._windows("cpu"))
    tab = unvoiced._cos_table("cpu").numpy()
    c = w0.shape[0]
    x = noise * win256[:, None]
    re, im = x[0::2], x[1::2]
    for h in (64, 32, 16, 8, 4, 2, 1):
        re, im = _fft_stage(re, im, tab, h, dif=True)
    zr, zi = re[BITREV7], im[BITREV7]                      # Z[k], natural order
    k = np.arange(128)
    partner = (128 - k) % 128
    kk = k[:, None]
    xr, xi = _split_bin(tab, kk, zr, zi, zr[partner], zi[partner])

    m = F(unvoiced.M_256_OVER_2PI) * w0
    lf = np.arange(57, dtype=F)[:, None]
    a_min = np.maximum(np.ceil((lf - F(0.5)) * m), F(0))
    b_max = np.minimum(np.ceil((lf + F(0.5)) * m), F(128))
    count = b_max - a_min
    e = np.zeros((57, c), F)
    for b in range(128):                                   # ascending bins
        inside = (a_min <= b) & (b < b_max)
        e = np.where(inside, e + (xr[b] * xr[b] + xi[b] * xi[b]), e)
    ok = ((lf >= 1) & (lf <= L[None, :]) & (Vl == 0) & (count > 0) & (e > 1e-10))
    mean = e / np.where(count > 0, count, F(1))
    scal = np.where(ok, F(unvoiced.UNVOICED_SCALE_COEFF) * Ml
                    / np.sqrt(np.where(mean > 0, mean, F(1))), F(0)) * F(1 / 256)
    scal = np.concatenate([scal, np.zeros((1, c), F)])
    f = np.take_along_axis(scal, _band_ids(m), 0)
    yr, yi = xr * f, xi * f
    yi[0] = 0                                              # bin 0 is real
    pr, pi = yr[partner], yi[partner]
    pr[0] = pi[0] = 0                                      # bin 128 carries no band
    zr, zi = _pack_bin(tab, kk, yr, yi, pr, pi)

    re, im = np.empty_like(zr), np.empty_like(zi)
    re[BITREV7], im[BITREV7] = zr, zi                      # slot bitrev(k) holds element k
    for h in (1, 2, 4, 8, 16, 32, 64):
        re, im = _fft_stage(re, im, tab, h, dif=False)
    uw = np.empty((256, c), F)
    uw[0::2], uw[1::2] = re, im

    pp = np.concatenate([prev, np.zeros((32, c), F)])
    cp = np.concatenate([np.zeros((32, c), F), uw[:128]])
    rcp = np.where(denom > 1e-10, F(1) / np.where(denom > 1e-10, denom, F(1)), F(0))
    add = (w_prev[:, None] * pp + w_curr[:, None] * cp) * rcp[:, None]
    return add, uw[128:]


@pytest.mark.parametrize("c", [100, 33])
def test_kernel_arithmetic_matches_plain(c):
    """The CUDA kernel's FFT, band-id and per-(band, channel) band-sum
    arithmetic, emulated in numpy at ragged C (100: three full blocks of
    32 and a partial one; 33: one lane in the last block) against the
    plain version: within 1e-4 of max |ref|; the band ids of bins 0..127
    equal the plain band_of_bins; the w0 = 0 lanes are silent."""
    args = _inputs(c, 11)
    got = _kernel_emulation(*args)
    want = [x.numpy() for x in unvoiced.unvoiced_wola_reference(*map(torch.from_numpy, args))]
    assert _rel_err(got, want) < TOL
    np.testing.assert_array_equal(got[1][:, :c // 8], 0.0)
    plain_band = unvoiced.band_of_bins(torch.from_numpy(args[0])).numpy()[:128]
    m = F(unvoiced.M_256_OVER_2PI) * args[0]
    np.testing.assert_array_equal(np.where((plain_band < 0) | (plain_band > 56), 57, plain_band),
                                  _band_ids(m))


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    """On CPU tensors synth.unvoiced_fft, the kernel's one caller, runs the
    plain version (no launch counted); the kernel's entry unvoiced_wola
    raises for a wrong dtype, shape or layout, and for a device with no
    kernel (the CPU, meta) after its checks."""
    args = [torch.from_numpy(a) for a in _inputs(24, 3)]
    before = build.LAUNCHES["unvoiced_wola"].n
    got = synth.unvoiced_fft(*args)
    want = unvoiced.unvoiced_wola_reference(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (160, 24) and got[1].shape == (128, 24)

    for i, bad in ((0, args[0].double()), (1, args[1].long()), (2, args[2][:56]),
                   (4, torch.zeros((256, 24))), (5, args[5].T.contiguous().T)):
        with pytest.raises(ValueError, match=r"unvoiced_wola: \w+ must be"):
            unvoiced.unvoiced_wola(*args[:i], bad, *args[i + 1:])
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match=f"no kernel for device {device}"):
            unvoiced.unvoiced_wola(*(a.to(device) for a in args))
    assert build.LAUNCHES["unvoiced_wola"].n == before
