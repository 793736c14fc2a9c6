"""Voiced oscillator bank: the hand-written CUDA kernel (csrc/voiced.cu)
and its plain PyTorch version.

    out[n, c] = w_prev[n] * sum_l g_prev*cos(phi_prev + n*s_prev)
              + w_cur[n]  * sum_l g_cur *cos(phi_cur0 + n*s_cur)
              + sum_{l<7} (a0 + n*da) * cos(phi0 + alpha*n + q*n^2)

for n = 0..159 (mbelib.c:953-1018). `voiced_sums` runs the plain version
for CPU tensors and launches the kernel for CUDA tensors; there is no
fallback between the two. The kernel is built with nvcc at first use
into build/ at the repository root, keyed by a hash of its source.
"""

import ctypes

import torch

from . import build

FRAME = 160
NHARM = 56
NINTERP = 7

SOURCE = build.CSRC / "voiced.cu"

# kernel launches made by voiced_sums (the plain version does not count)
LAUNCHES = 0
_FN = None


def voiced_sums_reference(gain_prev, phi_prev, step_prev, gain_cur, phi_cur0,
                          step_cur, interp_amp0, interp_damp, interp_phi0,
                          interp_alpha, interp_q, w_prev, w_cur):
    """The closed-form sums, evaluated directly (the numpy oracle of
    tests/test_pallas.py in torch). Shapes as voiced_sums."""
    n = torch.arange(FRAME, device=gain_prev.device, dtype=torch.float32)[None, :, None]

    def bank(g, phi, step):
        return (g[:, None, :] * torch.cos(phi[:, None, :] + step[:, None, :] * n)).sum(dim=0)

    theta = (interp_phi0[:, None, :] + interp_alpha[:, None, :] * n
             + interp_q[:, None, :] * n * n)
    interp = ((interp_amp0[:, None, :] + n * interp_damp[:, None, :])
              * torch.cos(theta)).sum(dim=0)
    return (w_prev[:, None] * bank(gain_prev, phi_prev, step_prev)
            + w_cur[:, None] * bank(gain_cur, phi_cur0, step_cur) + interp)


def load_library():
    """Build (if needed) and load the kernel library; returns the C entry
    point `mbe_voiced_sums` with its argument types set."""
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).mbe_voiced_sums
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(name, x, shape, device):
    if x.device != device or x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(f"voiced_sums: {name} must be float32 {shape} on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"voiced_sums: {name} must be contiguous")


def voiced_sums(gain_prev, phi_prev, step_prev, gain_cur, phi_cur0, step_cur,
                interp_amp0, interp_damp, interp_phi0, interp_alpha, interp_q,
                w_prev, w_cur):
    """Windowed voiced component [160, C] f32.

    Args (channel-minor, float32, any C):
      gain_prev/gain_cur [56, C]: 2*Ml with every mask folded in.
      phi_prev [56, C]: prev_PHIl; phi_cur0 [56, C]: cur_PHIl - cw0*l*160.
      step_prev/step_cur [56, C]: w0*l phase increments.
      interp_amp0/interp_damp [7, C]: the interpolated path's amplitude
        a0 + n*da (eligibility gate folded in).
      interp_phi0/interp_alpha/interp_q [7, C]: its quadratic phase.
      w_prev/w_cur [160]: the synthesis windows Ws[n+160] and Ws[n].
    """
    global LAUNCHES
    args = (gain_prev, phi_prev, step_prev, gain_cur, phi_cur0, step_cur,
            interp_amp0, interp_damp, interp_phi0, interp_alpha, interp_q,
            w_prev, w_cur)
    device = gain_prev.device
    if device.type == "cpu":
        return voiced_sums_reference(*args)
    if device.type != "cuda":
        raise ValueError(f"voiced_sums: no kernel for device {device}")
    c = gain_prev.shape[1]
    shapes = [(NHARM, c)] * 6 + [(NINTERP, c)] * 5 + [(FRAME,)] * 2
    for i, (x, shape) in enumerate(zip(args, shapes)):
        _check(f"argument {i}", x, shape, device)
    fn = load_library()
    out = torch.empty((FRAME, c), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(x.data_ptr() for x in args), out.data_ptr(), c, stream)
    if err != 0:
        raise RuntimeError(f"voiced_sums kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
