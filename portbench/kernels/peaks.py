"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), and the least time of a piece of work."""

HBM_BYTES_S = 3.35e12  # device memory
FP32_OPS_S = 33.5e12   # 67 TFLOP/s FP32 = 33.5T FMA lanes/s; one FP32 instruction per lane-op
BF16_FLOP_S = 989e12   # tensor cores, bf16 in, FP32 accumulate


def bound_s(nbytes, fp32_ops=0, bf16_flops=0):
    """The least seconds for `nbytes` moved, `fp32_ops` FP32 lane-ops on
    the CUDA cores and `bf16_flops` on the tensor cores: the larger of the
    bytes' time and the operations' (the two units run side by side, so
    the slower one sets it)."""
    return max(nbytes / HBM_BYTES_S, fp32_ops / FP32_OPS_S, bf16_flops / BF16_FLOP_S)
