"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W), against which every roofline share and ``step_mfu`` is
stated. A card set below 700 W runs slower under load; every run prints
the card's power limit beside these."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12     # float32 outside the tensor cores
TF32_FLOPS = 495e12    # TF32 on the tensor cores
BF16_FLOPS = 989e12    # bf16 on the tensor cores
# The draws run on two more pipes. At the clock at which the float32 rate
# is reached (132 SMs x 128 lanes x 2 flops), the CUDA C++ Programming
# Guide's throughput for compute capability 9.0 gives 64 32-bit integer
# multiplies an SM a clock (Philox) and 16 special functions (exp2, log2,
# rsqrt, reciprocal, sin, cos).
SMS = 132
BOOST_HZ = FP32_FLOPS / (SMS * 128 * 2)
INT32_MULS = 64 * SMS * BOOST_HZ
SFU_OPS = 16 * SMS * BOOST_HZ


def line() -> str:
    return (f"peaks (H100 SXM, published): HBM {HBM_BYTES_PER_S:.3e} B/s, "
            f"fp32 {FP32_FLOPS:.3e}, tf32 {TF32_FLOPS:.3e}, "
            f"bf16 {BF16_FLOPS:.3e} FLOP/s, int32 mul {INT32_MULS:.4e}/s, "
            f"sfu {SFU_OPS:.4e}/s")
