"""B2, the soft-decision ML search of Golay(23,12) and Hamming(15,11)
blocks (ecc.c:157-215, 303-357): for each block the winning key over
every codeword,

    score = sum_i rel_i * [bit_i != cw_i],  diffs over the data bits,

with the reference's tie-break. Launched per soft step once per group of
blocks; the launches (code, rows) of each codec are LAUNCHES."""

SYMBOL = "soft_decode_kernel"

# code -> (block length n, first data bit data_lo, codewords)
CODES = {"golay": (23, 11, 4096), "hamstd": (15, 0, 2048), "ham7100": (15, 0, 2048)}


def launches(codec, channels):
    """(code, rows) of each launch of one soft step of `codec`."""
    c = channels
    return {
        "imbe7200": [("golay", c), ("golay", 3 * c), ("hamstd", 3 * c)],
        "imbe7100": [("golay", c), ("golay", 3 * c), ("ham7100", 2 * c)],
        "ambe2450": [("golay", c), ("golay", c)],
        "ambe2400": [("golay", c), ("golay", c)],
    }[codec]


def work(codec, channels):
    """Least bytes, FP32 lane-ops and bf16 FLOPs of one soft step.

    Per launch of R rows: bits and rel read, idx_hard read, keys written
    (R * (8n + 8) bytes). Per (row, codeword): the product [q | h | hsum |
    1] @ codeword table, exact in bf16 with FP32 accumulation (operands <=
    255, sums < 2^18), of n + (n - data_lo) + 2 MACs on the tensor cores,
    then one min of the key on the CUDA cores."""
    out = dict(nbytes=0, fp32_ops=0, bf16_flops=0)
    for code, rows in launches(codec, channels):
        n, data_lo, ncw = CODES[code]
        out["nbytes"] += rows * (8 * n + 8)
        out["fp32_ops"] += rows * ncw
        out["bf16_flops"] += 2 * rows * ncw * (2 * n - data_lo + 2)
    return out
