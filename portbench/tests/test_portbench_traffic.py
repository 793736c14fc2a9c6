"""The traffic generator: valid frames, the bit-error and reliability
model, and the same bytes from the same seed."""

import numpy as np
import pytest
import torch

from portbench.reference import pipeline as ref
from portbench.reference.models.state import init_state
from portbench.traffic import generator as gen

MIX = dict(pool_ticks=4, erased=0.02, silence=0.04, tone=0.01,
           ber_levels=[0.0, 0.01, 0.05], ber_shares=[0.5, 0.35, 0.15])


@pytest.mark.parametrize("codec", ["imbe7200", "ambe2450"])
def test_clean_frames_decode_to_drawn_bits(codec):
    """Every frame of a clean channel that is not erased decodes back to
    its drawn parameter bits, with no errors counted."""
    pool = gen.make_pool(codec, 96, MIX, 2 ** 31 + 17, "cpu")
    state = init_state(96, pool.seeds.numpy(), carry_enh=codec.startswith("ambe"), device="cpu")
    clean = pool.ber == 0
    checked = 0
    for t in range(MIX["pool_ticks"]):
        state, _, res, d = ref.step(codec, pool.bits[t].to(torch.int32), state)
        keep = clean & (pool.kind[t] != gen.ERASED)
        assert torch.equal(d[keep].to(torch.uint8), pool.dbits[t][keep])
        assert int(res["total_errors"][keep].abs().sum()) == 0
        checked += int(keep.sum())
    assert checked > 150


def test_ambe_frame_kinds_decode_as_drawn():
    """AMBE+2 silence, tone and voice frames of clean channels are
    classified as drawn: tone frames set the tone flag, silence and voice
    frames neither tone nor erasure."""
    pool = gen.make_pool("ambe2450", 256, dict(MIX, silence=0.2, tone=0.2), 99, "cpu")
    state = init_state(256, pool.seeds.numpy(), carry_enh=True, device="cpu")
    _, _, res, _ = ref.step("ambe2450", pool.bits[0].to(torch.int32), state)
    clean = pool.ber == 0
    kind = pool.kind[0]
    tone = (res["flags"] & ref.FLAG_TONE) != 0
    era = (res["flags"] & ref.FLAG_ERASURE) != 0
    assert bool(tone[clean & (kind == gen.TONE)].all())
    for k in (gen.SILENCE, gen.VOICE):
        sel = clean & (kind == k)
        assert int(sel.sum()) > 5
        assert not bool(tone[sel].any()) and not bool(era[sel].any())


@pytest.mark.parametrize("level", [0.01, 0.05])
def test_ber_and_reliability_model(level):
    """The hard bits err at the level's rate, and the errors sit on the
    unreliable bits: y = s + sigma n with Q(1/sigma) = BER."""
    mix = dict(MIX, pool_ticks=64, erased=0.0, ber_levels=[level], ber_shares=[1.0])
    pool = gen.make_pool("imbe7200", 512, mix, 5, "cpu")
    clean = gen.encode("imbe7200", pool.dbits.to(torch.int32))
    flipped = pool.bits.to(torch.int32) != clean
    n = flipped.numel()
    ber = float(flipped.float().mean())
    assert abs(ber - level) < 5 * np.sqrt(level * (1 - level) / n)
    rel = pool.rel.to(torch.float32)
    assert float(rel[flipped].mean()) < 0.5 * float(rel[~flipped].mean())
    # |y| of a correct bit has mean E|1 + sigma n| > 1: quantised above 127
    assert float(rel[~flipped].mean()) > 127.0
    # the quantised |y| is the noise model's: P(rel < 128 * 0.5) matches
    sigma = float(gen.sigma_of(level))
    p_low = float((rel < 63.75).float().mean())
    from math import erf, sqrt

    def phi(x):
        return 0.5 * (1 + erf(x / sqrt(2)))
    expect = phi((0.5 - 1) / sigma) - phi((-0.5 - 1) / sigma)
    assert abs(p_low - expect) < 0.1 * expect + 1e-3


def test_channel_levels_in_their_shares():
    pool = gen.make_pool("imbe7200", 1000, dict(MIX, pool_ticks=1), 3, "cpu")
    counts = [int((pool.ber == lv).sum()) for lv in MIX["ber_levels"]]
    assert counts == [500, 350, 150]


@pytest.mark.parametrize("codec", ["imbe7200", "ambe2450"])
def test_same_seed_same_bytes(codec):
    a = gen.make_pool(codec, 64, MIX, 2 ** 31 + 3, "cpu")
    b = gen.make_pool(codec, 64, MIX, 2 ** 31 + 3, "cpu")
    c = gen.make_pool(codec, 64, MIX, 2 ** 31 + 4, "cpu")
    for f in ("bits", "rel", "dbits", "kind", "ber", "seeds"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.bits, c.bits)


def test_pack_is_numpy_packbits():
    bits = torch.randint(0, 2, (3, 5, 8, 23), dtype=torch.uint8)
    want = np.packbits(bits.reshape(3, 5, -1).numpy(), axis=-1)
    assert np.array_equal(gen.pack(bits).numpy(), want)
