"""B3, the unvoiced stage (mbe_unvoiced_fft.c:714-761), one launch per
step: the windowed noise's 256-point real DFT, per-band energies, band
scalors on the unvoiced bands, the scaled inverse DFT and the WOLA
combine with the previous frame's Uw."""

SYMBOL = "unvoiced_wola_kernel"


def work(channels):
    """Least bytes and FP32 lane-ops of one step at `channels` channels.

    Bytes, per channel: w0, L, Ml [57], Vl [57], previousUw [128] and the
    noise [256] read, add [160] and the new previousUw [128] written (788
    words), plus the window and table constants. Operations, per channel:
    two 256-point real FFTs at 2.5 N log2 N flops each, the window, |X|^2,
    the band sums and scalors, the bin scaling and the WOLA, ~12k ops."""
    c = channels
    nbytes = 4 * (788 * c + 256 + 256 + 3 * 160)
    ops = c * (2 * 5120 + 256 + 3 * 128 + 128 + 4 * 57 + 2 * 256 + 4 * 160)
    return dict(nbytes=nbytes, fp32_ops=ops, bf16_flops=0)
