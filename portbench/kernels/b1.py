"""B1, the voiced oscillator bank (mbelib.c:953-1018), one launch per step:

    out[n, c] = w_prev[n] * sum_l g_prev*cos(phi_prev + n*s_prev)
              + w_cur[n]  * sum_l g_cur *cos(phi_cur0 + n*s_cur)
              + sum_{l<7} (a0 + n*da) * cos(phi0 + alpha*n + q*n^2)

for n = 0..159, 56 harmonics per bank and 7 interpolated ones."""

SYMBOL = "voiced_sums_kernel"
COSF_OPS = 30  # FP32 instructions of one precise cosf or sincosf (estimate)


def work(channels):
    """Least bytes and FP32 lane-ops of one step at `channels` channels.

    Bytes: six [56, C] and five [7, C] float32 inputs, two [160] windows,
    a [160, C] output. Operations, per channel: 3 cosf per harmonic of
    the two 56-harmonic banks and 6 per interpolated harmonic to seed the
    oscillators (378 at ~30 instructions), then per sample one FMA
    (Chebyshev step) and one add (sum) per bank harmonic, 10 ops of the
    double rotor and amplitude per interpolated harmonic, and 3 for the
    windows: 58,860 FP32 ops."""
    c = channels
    nbytes = 4 * (6 * 56 * c + 5 * 7 * c + 2 * 160 + 160 * c)
    ops = c * ((3 * 2 * 56 + 6 * 7) * COSF_OPS + 160 * (2 * 2 * 56 + 10 * 7 + 3))
    return dict(nbytes=nbytes, fp32_ops=ops, bf16_flops=0)
