"""Log-domain spectral amplitude prediction, IMBE branch
(imbe_update_spectral_amplitudes, imbe7200x4400.c:294-354; port of
mbe_tpu.models.spectral) over channel-minor [57, C] lanes. The per-lane
row picks are gathers along the band axis."""

import torch


def _band_index(device):
    return torch.arange(57, device=device)[:, None]


def extend_prev(prev_Ml, prev_log2Ml, cur_L, prev_L):
    """Prev-model extension + [0]=[1] aliasing (imbe7200x4400.c:303-310):
    bands prev_L < l <= cur_L take band prev_L's value. Returns
    (prev_Ml', prev_log2Ml')."""
    idx = _band_index(prev_Ml.device)
    ext = ((cur_L > prev_L)[None, :] & (idx > prev_L[None, :])
           & (idx <= cur_L[None, :]))
    at = prev_L.long()[None, :]

    def one(a):
        out = torch.where(ext, torch.gather(a, 0, at), a)
        return torch.where(idx == 0, a[1:2, :], out)

    return one(prev_Ml), one(prev_log2Ml)


def spectral_update(cur_L, prev_L, prev_Ml, prev_log2Ml, Tl, *, weight,
                    cur_Ml, cur_log2Ml):
    """Log-domain prediction of the current spectral amplitudes.

    Args: cur_L/prev_L [C] i32 (clamped to [1, 56]); prev_Ml/prev_log2Ml
    [57, C] pre-mutation previous model; Tl [57, C] IDCT residuals;
    weight [C] f32 (rho); cur_Ml/cur_log2Ml [57, C] (entries above L kept).
    Returns (cur_Ml', cur_log2Ml', prev_Ml', prev_log2Ml', cur_L_clamped).
    """
    cL = torch.clamp(cur_L, 1, 56)
    pL = torch.clamp(prev_L, 1, 56)
    pM, pLg = extend_prev(prev_Ml, prev_log2Ml, cL, pL)

    idx = _band_index(Tl.device)
    lf = idx.to(torch.float32)
    mask = (idx >= 1) & (idx <= cL[None, :])
    flokl = (pL.to(torch.float32) / cL.to(torch.float32))[None, :] * lf
    intkl = torch.clamp(flokl.to(torch.int64), 0, 56)
    deltal = flokl - intkl.to(torch.float32)
    lg_lo = torch.gather(pLg, 0, intkl)
    lg_hi = torch.gather(pLg, 0, torch.clamp(intkl + 1, max=56))

    interp = (1.0 - deltal) * lg_lo + deltal * lg_hi
    ssum = torch.where(mask, interp, 0.0).sum(dim=0)
    wsum = (weight / cL.to(torch.float32)) * ssum  # Sum43 / Sum77

    w = weight[None, :]
    c1 = w * (1.0 - deltal) * lg_lo
    c2 = w * deltal * lg_hi
    log2Ml = Tl + c1 + c2 - wsum[None, :]
    Ml = torch.exp2(log2Ml)

    return (torch.where(mask, Ml, cur_Ml), torch.where(mask, log2Ml, cur_log2Ml),
            pM, pLg, cL)
