"""Frame descrambling PRNG via affine jumps (port of mbe_tpu.ops.demod).

pr[k+1] = (173*pr[k] + 13849) mod 2^16 (ambe_common.c:86-92,
imbe7200x4400.c:650-656) composes to pr[k] = (A[k]*pr[0] + B[k]) mod
2^16 with the jump tables demod_prng_A/B, so the keystream of a batch of
frames is one elementwise expression. Arithmetic in int64 with an
explicit 16-bit mask.
"""

import torch

from ..tables import table


def prng_bits(seed, count):
    """Keystream bits pr[1..count] >> 15 for a batch of seeds.

    Args: seed [C] int, pr[0] (already multiplied by 16); count static.
    Returns: [count, C] int64 in {0,1} (channel-minor).
    """
    a = table("demod_prng_A", seed.device)[1:count + 1].long()[:, None]
    b = table("demod_prng_B", seed.device)[1:count + 1].long()[:, None]
    pr = (a * seed.long()[None, :] + b) & 0xFFFF
    return pr >> 15


def prng_keywords(seed, widths):
    """Keystream packed into one word per demodulated row: bit j of word r
    is keystream bit offset_r + (width_r-1-j) (the C applies pr
    MSB-column-first, ambe_common.c:94-99).

    Returns: [len(widths), C] int32.
    """
    bits = prng_bits(seed, sum(widths))
    words = []
    k = 0
    for w in widths:
        shifts = torch.arange(w - 1, -1, -1, device=seed.device)[:, None]
        words.append((bits[k:k + w] << shifts).sum(dim=0))
        k += w
    return torch.stack(words).to(torch.int32)
