"""Batched speech synthesis core (mbe_synthesizeSpeechCore,
mbelib.c:1042-1105; port of mbe_tpu.models.speech).

Every lane computes the voiced, unvoiced and comfort-noise paths; per-lane
masks pick what commits:
- adaptive smoothing commits even for muted frames (mbelib.c:1057-1064);
- muted frames emit comfort noise and advance neither the noise LCG, the
  phases nor previousUw (mbelib.c:1069-1073);
- the comfort-noise RNG advances only on lanes that emitted it.
"""

import dataclasses

import torch

from ..ops import enhance, noise, synth
from .state import Parms


def _valid_L(L):
    return (L >= 1) & (L <= 56)


def should_mute(cur: Parms):
    """mbe_should_mute_speech (mbelib.c:895-899)."""
    mute_on_error_rate = torch.abs(cur.mutingThreshold - 0.096) > 1e-6
    return (cur.repeatCount >= 4) | (mute_on_error_rate
                                     & (cur.errorRate > cur.mutingThreshold))


def synthesize_speech_core(cur: Parms, prev: Parms, comfort_samples,
                           lcg_prime, rm0):
    """One batched frame of speech synthesis.

    Args:
      cur, prev: Parms (prev is prev_mp_enhanced in the process paths).
      comfort_samples: [160, C] f32 comfort noise for this frame.
      lcg_prime: [C] f32 cold-start LCG prime values.
      rm0: [C] f32 pre-enhancement spectral energy.
    Returns:
      (audio [160, C] f32, cur', prev', aux) with aux [C] bool masks
      `mute` (lanes that consumed the comfort samples) and `cold_consumed`
      (lanes whose one-shot LCG seed override was consumed,
      mbe_unvoiced_fft.c:315-318).
    """
    valid = _valid_L(cur.L) & _valid_L(prev.L)

    # --- adaptive smoothing (always, even when muted) --------------------
    Ml_s, Vl_s, local_e, amp_t = enhance.adaptive_smoothing(
        cur.Ml, cur.Vl, cur.L, cur.errorRate, cur.errorCountTotal,
        cur.errorCount4, prev.localEnergy, prev.amplitudeThreshold, rm0)
    cur = dataclasses.replace(
        cur,
        Ml=torch.where(valid[None, :], Ml_s, cur.Ml),
        Vl=torch.where(valid[None, :], Vl_s, cur.Vl),
        localEnergy=torch.where(valid, local_e, cur.localEnergy),
        amplitudeThreshold=torch.where(valid, amp_t, cur.amplitudeThreshold))

    mute = should_mute(cur) & valid
    speak = valid & ~mute

    # --- noise buffer (LCG state advances on speaking lanes only) ---------
    cold_consumed = speak & (cur.noiseSeed < 0.0)
    noise_buf, new_seed, new_prev_seed = noise.generate_noise_with_overlap(
        cur.noiseSeed, cur.noisePrevSeed, lcg_prime)

    # --- model reconciliation + phase update -------------------------------
    maxl, c_Ml, c_Vl, p_Ml, p_Vl = synth.reconcile_model_lengths(
        cur.L, cur.Ml, cur.Vl, prev.L, prev.Ml, prev.Vl)
    num_uv = synth.count_unvoiced(c_Vl, cur.L)
    c_psi, c_phi, p_psi = synth.update_phases(
        cur.w0, cur.L, cur.PSIl, cur.PHIl, prev.w0, prev.PSIl, noise_buf,
        num_uv)

    # --- voiced + unvoiced render -----------------------------------------
    voiced = synth.render_voiced(cur.w0, c_Ml, c_Vl, c_phi,
                                 prev.w0, p_Ml, p_Vl, prev.PHIl, maxl)
    unvoiced_add, new_uw = synth.unvoiced_fft(
        cur.w0, cur.L, c_Ml, c_Vl, prev.previousUw, noise_buf)
    speech = synth.clip_float(voiced + unvoiced_add)

    audio = torch.where(speak[None, :], speech,
                        torch.where(mute[None, :], comfort_samples, 0.0))

    sp = speak[None, :]
    cur = dataclasses.replace(
        cur,
        Ml=torch.where(sp, c_Ml, cur.Ml),
        Vl=torch.where(sp, c_Vl, cur.Vl),
        PSIl=torch.where(sp, c_psi, cur.PSIl),
        PHIl=torch.where(sp, c_phi, cur.PHIl),
        previousUw=torch.where(sp, new_uw, cur.previousUw),
        noiseSeed=torch.where(speak, new_seed, cur.noiseSeed),
        noisePrevSeed=torch.where(speak, new_prev_seed, cur.noisePrevSeed))
    prev = dataclasses.replace(
        prev,
        Ml=torch.where(sp, p_Ml, prev.Ml),
        Vl=torch.where(sp, p_Vl, prev.Vl),
        PSIl=torch.where(sp, p_psi, prev.PSIl))
    return audio, cur, prev, dict(mute=mute, cold_consumed=cold_consumed)


def current_frame_rm0(cur: Parms):
    """mbe_current_frame_rm0 (mbe_adaptive.c:151-161)."""
    mask = enhance.band_mask(cur.L)
    rm0 = torch.where(mask, cur.Ml * cur.Ml, 0.0).sum(dim=0)
    return torch.where(_valid_L(cur.L), rm0, 0.0)
