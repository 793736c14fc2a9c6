"""The traffic generator: one pool of valid over-the-air frames per run,
drawn from the run's seed, with channel bit errors and soft reliabilities.

Every traffic mix (a JSON file beside this one) is read by this one
generator. Per (tick, channel) a frame is drawn as one of

- voice: seeded parameter bits with a valid pitch index (IMBE b0 < 208,
  AMBE+2 b0 < 120), encoded;
- erased: every bit random (a lost frame);
- silence (AMBE+2 only): b0 124 or 125;
- tone (AMBE+2 only): the tone pattern of ambe3600x2450.c:474-491 with a
  valid tone id;

in the mix's shares, and encoded as the codec's decoder reads it (Golay
and Hamming codewords, the PRNG scrambling of ambe_common.c:75-100 and
imbe7200x4400.c:424-707, bit planes). Each channel has one bit-error
level of the mix for the whole run. One noise model gives both hard bits
and reliabilities: the symbol y = s + sigma * n (s = +1 for a 0 bit, -1
for a 1 bit), sigma the one that gives the level's bit-error rate
(Q(1/sigma) = BER); the hard bit is y < 0, the reliability |y| * 127.5
rounded and clipped to 0..255 (ops/ecc.py reads 0 as no confidence).

The pool is made in a few large tensor operations on the run's device,
with a torch.Generator seeded from the run's seed: the same seed on the
same device gives the same bytes.
"""

import dataclasses
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

TABLES = Path(__file__).resolve().parent.parent / "reference" / "tables.npz"

FRAME_SHAPES = {"imbe7200": (8, 23), "ambe2450": (4, 24)}
NBITS = {"imbe7200": 88, "ambe2450": 49}
VOICE, ERASED, SILENCE, TONE = 0, 1, 2, 3
# bit positions of b0 in the parameter bits, MSB first
B0_BITS = {"imbe7200": (0, 1, 2, 3, 4, 5, 85, 86), "ambe2450": (0, 1, 2, 3, 37, 38, 39)}
B0_VOICE = {"imbe7200": 208, "ambe2450": 120}


@dataclasses.dataclass
class Pool:
    """bits, rel [T, C, rows, cols] uint8 (hard bits, reliabilities);
    dbits [T, C, nbits] uint8 the drawn parameter bits; kind [T, C] int8
    (VOICE, ERASED, SILENCE, TONE); ber [C] float32, each channel's level;
    seeds [C] int64, each channel's uint32 RNG seed."""

    bits: torch.Tensor
    rel: torch.Tensor
    dbits: torch.Tensor
    kind: torch.Tensor
    ber: torch.Tensor
    seeds: torch.Tensor


@lru_cache(maxsize=None)
def _codebooks(device):
    """(Golay codewords [4096, 23], Hamming codewords by data word [2048,
    15]) as int32 on `device`, LSB-first as the decoders read them."""
    with np.load(TABLES) as z:
        golay = z["golay_codewords"].astype(np.int32)
        ham = z["hamming_codewords_std"].astype(np.int32)
    keys = (ham[:, 4:] * (1 << np.arange(11))).sum(axis=1)
    by_data = np.zeros_like(ham)
    by_data[keys] = ham
    return torch.from_numpy(golay).to(device), torch.from_numpy(by_data).to(device)


@lru_cache(maxsize=None)
def valid_tones():
    """The tone ids the decoders play (tone_valid != 0)."""
    with np.load(TABLES) as z:
        return np.nonzero(z["tone_valid"])[0].astype(np.int64)


def _msb_value(d, lo, n):
    """Value of bits d[..., lo:lo+n], the first the MSB."""
    w = 1 << torch.arange(n - 1, -1, -1, device=d.device, dtype=torch.int64)
    return (d[..., lo:lo + n].to(torch.int64) * w).sum(dim=-1)


def _set_bits(d, positions, value):
    """Write `value` [...] into d at `positions`, the first the MSB."""
    n = len(positions)
    for i, p in enumerate(positions):
        d[..., p] = ((value >> (n - 1 - i)) & 1).to(d.dtype)


def _keystream(data0, count):
    """pr[1..count] >> 15 of the PRNG seeded with 16 * data0
    (ambe_common.c:86-92): [..., count] int32."""
    p = (16 * data0) & 0xFFFF
    out = []
    for _ in range(count):
        p = (173 * p + 13849) & 0xFFFF
        out.append(p >> 15)
    return torch.stack(out, dim=-1).to(torch.int32)


def encode(codec, d):
    """Parameter bits d [..., nbits] (0/1) -> clean frames [..., rows, cols]
    int32, the inverse of the codec's frame decode."""
    golay, ham = _codebooks(d.device)
    lead = d.shape[:-1]
    fr = torch.zeros((*lead, *FRAME_SHAPES[codec]), dtype=torch.int32, device=d.device)
    data0 = _msb_value(d, 0, 12)
    if codec == "imbe7200":
        fr[..., 0, :] = golay[data0]
        key = _keystream(data0, 114)
        k = 0
        for i in range(1, 4):
            fr[..., i, :] = golay[_msb_value(d, 12 * i, 12)] ^ key[..., k:k + 23].flip(-1)
            k += 23
        for m, i in enumerate(range(4, 7)):
            fr[..., i, :15] = ham[_msb_value(d, 48 + 11 * m, 11)] ^ key[..., k:k + 15].flip(-1)
            k += 15
        fr[..., 7, :7] = d[..., 81:88].flip(-1)
    elif codec == "ambe2450":
        g0 = golay[data0]
        fr[..., 0, 1:] = g0
        fr[..., 0, 0] = g0.sum(dim=-1) & 1   # Golay24 even parity
        key = _keystream(data0, 23)
        fr[..., 1, :23] = golay[_msb_value(d, 12, 12)] ^ key.flip(-1)
        fr[..., 2, :11] = d[..., 24:35].flip(-1)
        fr[..., 3, :14] = d[..., 35:49].flip(-1)
    else:
        raise ValueError(f"no encoder for codec {codec!r}")
    return fr


def sigma_of(ber):
    """The noise sigma at which a hard decision errs with probability ber
    (0 -> 0): 1 / Q^-1(ber)."""
    ber = torch.as_tensor(ber, dtype=torch.float64)
    return torch.where(ber > 0, 1.0 / torch.special.ndtri(1.0 - ber.clamp(min=1e-300)),
                       torch.zeros_like(ber)).to(torch.float32)


def _shares(n, shares, gen, device):
    """n labels 0..len(shares)-1 in the given shares (rounded, the rest to
    the first), in a seeded random order."""
    counts = [int(round(n * s)) for s in shares]
    counts[0] += n - sum(counts)
    labels = torch.cat([torch.full((c,), i, dtype=torch.int64) for i, c in enumerate(counts)])
    return labels.to(device)[torch.randperm(n, generator=gen, device=device)]


def make_pool(codec, channels, mix, seed, device):
    """The run's pool of mix["pool_ticks"] ticks for `channels` channels
    (see the module docstring). `mix` holds the shares `erased`,
    `silence`, `tone` (the last two AMBE+2 only), `ber_levels` and
    `ber_shares`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    t, c, nb = int(mix["pool_ticks"]), int(channels), NBITS[codec]
    rows, cols = FRAME_SHAPES[codec]

    seeds = torch.randint(1, 2 ** 32, (c,), generator=gen, device=device, dtype=torch.int64)
    levels = torch.tensor(mix["ber_levels"], dtype=torch.float32, device=device)
    ber = levels[_shares(c, mix["ber_shares"], gen, device)]

    d = torch.randint(0, 2, (t, c, nb), generator=gen, device=device, dtype=torch.uint8)
    u = torch.rand((t, c), generator=gen, device=device)
    kind = torch.full((t, c), VOICE, dtype=torch.int8, device=device)
    edge = float(mix["erased"])
    kind[u < edge] = ERASED
    if codec == "ambe2450":
        kind[(u >= edge) & (u < edge + mix["silence"])] = SILENCE
        edge += mix["silence"]
        kind[(u >= edge) & (u < edge + mix["tone"])] = TONE

    b0 = torch.randint(0, B0_VOICE[codec], (t, c), generator=gen, device=device)
    if codec == "ambe2450":
        b0 = torch.where(kind == SILENCE, 124 + (b0 & 1), b0)
    _set_bits(d, B0_BITS[codec], b0)
    if codec == "ambe2450":
        sil = kind == SILENCE
        d[..., 4] = torch.where(sil, 0, d[..., 4])   # d[0..5] not all ones: no tone
        tone = (kind == TONE)[..., None]
        tones = torch.from_numpy(valid_tones()).to(device)
        tid = tones[torch.randint(0, len(tones), (t, c), generator=gen, device=device)]
        td = d.clone()
        td[..., 0:6] = 1
        _set_bits(td, range(12, 20), tid)
        td[..., 20:24] = td[..., 12:16]
        td[..., 45:49] = 0
        d = torch.where(tone, td, d)

    clean = encode(codec, d)
    rnd = torch.randint(0, 2, clean.shape, generator=gen, device=device, dtype=torch.int32)
    clean = torch.where((kind == ERASED)[..., None, None], rnd, clean)
    del rnd

    sigma = sigma_of(ber).to(device)[None, :, None, None]
    y = (1.0 - 2.0 * clean.to(torch.float32)) + sigma * torch.randn(
        clean.shape, generator=gen, device=device)
    bits = (y < 0).to(torch.uint8)
    rel = torch.clamp(torch.round(y.abs() * 127.5), 0, 255).to(torch.uint8)
    del y
    return Pool(bits=bits, rel=rel, dbits=d, kind=kind, ber=ber, seeds=seeds)


def pack(bits):
    """Bit planes [..., rows, cols] (0/1) -> bytes [..., ceil(rows*cols/8)]
    uint8, MSB first (np.packbits order), as a receiver hands them on."""
    flat = bits.reshape(*bits.shape[:-2], -1).to(torch.int32)
    n = flat.shape[-1]
    pad = (-n) % 8
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    w = 1 << torch.arange(7, -1, -1, device=bits.device, dtype=torch.int32)
    return (flat.reshape(*flat.shape[:-1], -1, 8) * w).sum(dim=-1).to(torch.uint8)
