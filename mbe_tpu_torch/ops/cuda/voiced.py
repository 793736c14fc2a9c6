"""Voiced oscillator bank: the hand-written CUDA kernel (csrc/voiced.cu)
and its plain PyTorch version.

    out[n, c] = w_prev[n] * sum_l g_prev*cos(phi_prev + n*s_prev)
              + w_cur[n]  * sum_l g_cur *cos(phi_cur0 + n*s_cur)
              + sum_{l<7} (a0 + n*da) * cos(phi0 + alpha*n + q*n^2)

for n = 0..159 (mbelib.c:953-1018). `voiced_sums` launches the kernel;
its one caller, ops/synth.render_voiced, runs `voiced_sums_reference` for
CPU tensors instead.
"""

import torch

from . import build

FRAME = 160
NHARM = 56
NINTERP = 7

KERNEL = build.register(build.Kernel("voiced_sums", build.CSRC / "voiced.cu", "mbe_voiced_sums",
                                     [build.PTR] * 14 + [build.INT, build.PTR], None))


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
    args = (gain_prev, phi_prev, step_prev, gain_cur, phi_cur0, step_cur,
            interp_amp0, interp_damp, interp_phi0, interp_alpha, interp_q,
            w_prev, w_cur)
    c = gain_prev.shape[-1]
    shapes = [(NHARM, c)] * 6 + [(NINTERP, c)] * 5 + [(FRAME,)] * 2
    device = build.check("voiced_sums", [(f"argument {i}", x, torch.float32, shape)
                                         for i, (x, shape) in enumerate(zip(args, shapes))])
    out = torch.empty((FRAME, c), dtype=torch.float32, device=device)
    KERNEL.launch(device, *args, out, c)
    return out
