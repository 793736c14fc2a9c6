"""The port's StreamingDecoder (mbe_tpu_torch.parallel.streaming) and host
helpers (mbe_tpu_torch.native).

The streamed PCM and results equal direct pipeline.step calls frame for
frame (tolerance 0) at every window depth, from packed bytes unpacked on
the device or on the host and from bit arrays; the numpy host helpers
equal their definitions and mbe_tpu.native's. The pinned-buffer CUDA path
is held on the card (tests/test_torch_cuda.py, chip_smoke.py phase 7)."""

import numpy as np
import pytest
import torch

from mbe_tpu import native as jnative
from mbe_tpu_torch import native, pipeline
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import synth
from mbe_tpu_torch.parallel import streaming
from mbe_tpu_torch.parallel.streaming import StreamingDecoder

torch.set_num_threads(1)

RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors", "flags")


def _direct(codec, frames, seeds, int16=True):
    state = st.init_state(frames.shape[1], rng_seed=seeds, device="cpu")
    out = []
    for t in range(frames.shape[0]):
        state, audio, res, _ = pipeline.step(codec, torch.from_numpy(frames[t]), state)
        out.append(((synth.float_to_short(audio) if int16 else audio).numpy(),
                    {k: res[k].numpy() for k in RES_KEYS}))
    return out


def _stream(dec, inputs):
    got = []
    for x in inputs:
        got.extend(dec.push(x))
    got.extend(dec.flush())
    return got


def _assert_same(got, want):
    assert len(got) == len(want)
    for t, ((pcm, res), (pcm_w, res_w)) in enumerate(zip(got, want)):
        assert pcm.dtype == pcm_w.dtype
        np.testing.assert_array_equal(pcm, pcm_w, err_msg=f"t={t}")
        for k in RES_KEYS:
            np.testing.assert_array_equal(res[k], res_w[k], err_msg=f"t={t} {k}")


@pytest.fixture(scope="module")
def ambe_stream():
    C, T = 8, 6
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 2, (T, C, 4, 24)).astype(np.int32)
    seeds = np.arange(1, C + 1).astype(np.uint32)
    return frames, seeds, _direct("ambe2450", frames, seeds)


@pytest.mark.parametrize("unpack", ["device", "host"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_matches_direct_steps(ambe_stream, depth, unpack):
    """Packed bytes ([C, 12] uint8 per tick) through the in-flight window:
    PCM and every result word equal the direct steps'; the window yields
    nothing until it holds `depth` ticks."""
    frames, seeds, want = ambe_stream
    C, T = frames.shape[1], frames.shape[0]
    dec = StreamingDecoder("ambe2450", C, rng_seed=seeds, depth=depth, unpack=unpack,
                           device="cpu")
    got = []
    for t in range(T):
        packed = np.packbits(frames[t].reshape(C, 96).astype(np.uint8), axis=1)
        out = list(dec.push(packed))
        assert len(out) == (1 if t >= depth else 0)
        got.extend(out)
    got.extend(dec.flush())
    _assert_same(got, want)
    assert list(dec.flush()) == []


def test_streaming_bit_arrays_and_float_pcm():
    """[C, rows, cols] bit arrays on imbe7200 with int16=False: float PCM
    and results equal the direct steps'."""
    C, T = 4, 4
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 2, (T, C, 8, 23)).astype(np.int32)
    seeds = np.arange(7, 7 + C).astype(np.uint32)
    dec = StreamingDecoder("imbe7200", C, rng_seed=seeds, depth=2, int16=False, device="cpu")
    _assert_same(_stream(dec, frames), _direct("imbe7200", frames, seeds, int16=False))


def test_streaming_rejects_bad_arguments(monkeypatch):
    with pytest.raises(ValueError, match="codec"):
        StreamingDecoder("imbe9999", 2, device="cpu")
    with pytest.raises(ValueError, match="unpack"):
        StreamingDecoder("imbe7200", 2, unpack="gpu", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingDecoder("imbe7200", 2)


def test_bundle_round_trip():
    """_bundle packs PCM and the five result words into one tensor and
    _unbundle recovers them bit for bit, for float32 and int16 PCM, with
    result words whose bits are NaN patterns as float32."""
    words = np.array([0, -1, 0x7FC00001, -0x800000, 184, 0x7F800001], np.int32)
    res = {k: torch.from_numpy(np.roll(words, i)) for i, k in enumerate(streaming._RES_KEYS)}
    for pcm in (torch.randn(6, 160), torch.randint(-32768, 32767, (6, 160), dtype=torch.int16)):
        buf = streaming._bundle(pcm, res)
        assert buf.dtype == pcm.dtype and buf.shape[0] == 6
        audio, back = streaming._unbundle(buf.numpy())
        np.testing.assert_array_equal(audio, pcm.numpy())
        for k in streaming._RES_KEYS:
            np.testing.assert_array_equal(back[k], res[k].numpy(), err_msg=k)


def test_unpack_bits_device_matches_numpy():
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 256, (8, 23)).astype(np.uint8)
    got = streaming.unpack_bits_device(torch.from_numpy(packed), 184)
    want = np.unpackbits(packed, axis=1)[:, :184].astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(streaming.unpack_bits_device(torch.from_numpy(packed), 100),
                                  want[:, :100])


# --- host helpers (tests/test_native.py) -------------------------------------

def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (16, 96)).astype(np.int32)
    packed = native.pack_bits(bits)
    assert packed.shape == (16, 12) and packed.dtype == np.uint8
    np.testing.assert_array_equal(native.unpack_bits(packed, 96), bits)
    odd = rng.integers(0, 2, (3, 49)).astype(np.int32)
    np.testing.assert_array_equal(native.pack_bits(odd), jnative.pack_bits(odd))
    np.testing.assert_array_equal(native.unpack_bits(native.pack_bits(odd), 49), odd)


def test_unpack_matches_numpy():
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 256, (8, 23)).astype(np.uint8)
    want = np.unpackbits(packed, axis=1)[:, :184].astype(np.int32)
    for got in (native.unpack_bits(packed, 184), jnative.unpack_bits(packed, 184)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.unpack_bits(packed[0], 184), want[:1])


def test_interleave():
    rng = np.random.default_rng(2)
    pcm = rng.integers(-1000, 1000, (4, 160)).astype(np.int16)
    got = native.interleave_pcm(pcm)
    assert got.dtype == np.int16 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, pcm.T)


@pytest.mark.parametrize("idx", [[0, 5, -1, 11], [0, 12, 13, 100, 11, -3]],
                         ids=["negative", "high"])
def test_scatter(idx):
    """out[f, k] = bits[f, idx[k]], 0 for an index outside [0, n_in)."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (2, 12)).astype(np.int32)
    idx = np.array(idx, np.int32)
    want = np.where((idx >= 0) & (idx < 12), bits[:, np.clip(idx, 0, 11)], 0)
    got = native.scatter_bits(bits, idx, len(idx))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.scatter_bits(bits, idx, len(idx)))
