"""The unvoiced stage (kernel B3, ops/cuda/unvoiced.py) on the CPU: its
plain version against the JAX Pallas kernel (interpret mode) and the JAX
XLA stage, a numpy emulation of the CUDA kernel's arithmetic against the
plain version, and the wrapper's dispatch and input checks."""

import numpy as np
import pytest
import torch

from mbe_tpu.ops import synth as jsynth
from mbe_tpu_torch.ops import synth
from mbe_tpu_torch.ops.cuda import unvoiced

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


def _kernel_emulation(w0, L, Ml, Vl, prev, noise):
    """The arithmetic of csrc/unvoiced.cu in numpy float32: the radix-2
    split of both DFTs against the 256-entry cosine table (-sin read 64
    entries on), band ids of bins 0..127 with two correction rounds,
    sequential per-band energy sums, band 57 as the zero row."""
    win256, w_prev, w_curr, denom = (x.numpy()[:, 0] for x in unvoiced._windows("cpu"))
    tab = unvoiced._cos_table("cpu").numpy()
    c = w0.shape[0]
    x = noise * win256[:, None]
    halves = (x[:128] + x[128:], x[:128] - x[128:])
    n = np.arange(128)
    k = np.arange(128)
    idx = (n[:, None] * k[None, :]) & 255                    # [n, k]
    cr, ci = tab[idx], tab[(idx + 64) & 255]
    re = np.where((k % 2 == 0)[:, None], cr.T @ halves[0], cr.T @ halves[1])  # [k, C]
    im = np.where((k % 2 == 0)[:, None], ci.T @ halves[0], ci.T @ halves[1])

    m = np.float32(unvoiced.M_256_OVER_2PI) * w0
    kf = k.astype(np.float32)[:, None]
    safe = m > 0
    band = np.floor(kf / np.where(safe, m, np.float32(1)) + np.float32(0.5))
    for _ in range(2):
        lo = np.ceil((band - np.float32(0.5)) * m)
        hi = np.ceil((band + np.float32(0.5)) * m)
        band = band + (kf >= hi) - (kf < lo)
    band = np.where(safe & (band >= 0) & (band <= 56), band, 57).astype(np.int64)

    mag2 = re * re + im * im
    energy = np.zeros((58, c), np.float32)
    for kk in range(128):
        np.add.at(energy, (band[kk], np.arange(c)), mag2[kk])
    lf = np.arange(57, dtype=np.float32)[:, None]
    count = (np.minimum(np.ceil((lf + np.float32(0.5)) * m), np.float32(128))
             - np.maximum(np.ceil((lf - np.float32(0.5)) * m), np.float32(0)))
    e = energy[:57]
    ok = ((lf >= 1) & (lf <= L[None, :]) & (Vl == 0) & (count > 0) & (e > 1e-10))
    mean = e / np.where(count > 0, count, np.float32(1))
    scal = np.where(ok, np.float32(unvoiced.UNVOICED_SCALE_COEFF) * Ml
                    / np.sqrt(np.where(mean > 0, mean, np.float32(1))), np.float32(0))
    scal = np.concatenate([scal, np.zeros((1, c), np.float32)])
    f = np.take_along_axis(scal, band, 0) * np.where(k == 0, 1.0, 2.0).astype(np.float32)[:, None] \
        / np.float32(256)
    yre, yim = re * f, im * f
    idx_inv = (n[:, None] * k[None, :]) & 255                # [n, k]
    terms_r, terms_i = tab[idx_inv], tab[(idx_inv + 64) & 255]
    even, odd = k % 2 == 0, k % 2 == 1
    ev = terms_r[:, even] @ yre[even] + terms_i[:, even] @ yim[even]
    od = terms_r[:, odd] @ yre[odd] + terms_i[:, odd] @ yim[odd]
    uw = np.concatenate([ev + od, ev - od])                  # [256, C]

    pp = np.concatenate([prev, np.zeros((32, c), np.float32)])
    cp = np.concatenate([np.zeros((32, c), np.float32), uw[:128]])
    add = np.where((denom > 1e-10)[:, None],
                   (w_prev[:, None] * pp + w_curr[:, None] * cp)
                   / np.where(denom > 1e-10, denom, 1)[:, None], 0.0)
    return add.astype(np.float32), uw[128:]


def test_kernel_arithmetic_matches_plain():
    """The CUDA kernel's split-DFT, band-id and sequential band-sum
    arithmetic, emulated in numpy at a ragged C = 100, against the plain
    version: within 1e-4 of max |ref|; the band ids of bins 0..127 equal
    the plain band_of_bins."""
    args = _inputs(100, 11)
    got = _kernel_emulation(*args)
    want = [x.numpy() for x in unvoiced.unvoiced_wola_reference(*map(torch.from_numpy, args))]
    assert _rel_err(got, want) < TOL
    np.testing.assert_array_equal(got[1][:, :12], 0.0)


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    """On CPU tensors unvoiced_wola is the plain version (no launch
    counted), and synth.unvoiced_fft is unvoiced_wola; a wrong dtype,
    shape or layout raises; a device with no kernel raises."""
    args = [torch.from_numpy(a) for a in _inputs(24, 3)]
    before = unvoiced.LAUNCHES
    got = unvoiced.unvoiced_wola(*args)
    want = unvoiced.unvoiced_wola_reference(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(synth.unvoiced_fft(*args), want))
    assert unvoiced.LAUNCHES == before
    assert got[0].shape == (160, 24) and got[1].shape == (128, 24)

    for i, bad in ((0, args[0].double()), (1, args[1].long()), (2, args[2][:56]),
                   (4, torch.zeros((256, 24))), (5, args[5].T.contiguous().T)):
        with pytest.raises(ValueError, match="unvoiced_wola"):
            unvoiced.unvoiced_wola(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        unvoiced.unvoiced_wola(*(a.to("meta") for a in args))
