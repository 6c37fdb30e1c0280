"""The least time the card could take for a kernel's work, counted from
the shapes of the call's inputs, the same whatever implements it.

Peaks: NVIDIA H100 SXM data sheet, dense rates (copied from chip_smoke.py,
with `roofline`, `pass_b_bound` and `viterbi_bound`): 3.35 TB/s of HBM3,
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them.  The
float32 peak counts an FMA as two operations; an add, a product or a
compare alone is one instruction, so such work runs at most at half of it.
A share of a roofline is stated against these peaks, with the card's power
limit beside it.
"""

from __future__ import annotations

PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
PEAK_F32_OP = PEAK_F32 / 2
HALF_FRAME, SYMBOL, ROOTS = 9600, 128, 3


def roofline(ops: float, nbytes: float, peak_ops: float = PEAK_F32_OP) \
        -> tuple[float, str]:
    """(seconds, what sets it): the larger of `ops` over `peak_ops` and
    bytes over the memory rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pass_a(lanes: int, steps: int, bf16: bool = True) -> tuple[float, str]:
    """Pass A of `steps` half-frame steps of `lanes` channels: every
    candidate start of every root a 128-tap complex correlation (8
    operations a tap: four products, four sums) and its power (3), at the
    rate of the input type; the samples the steps read (steps x 9600 + 128
    complex float32) read once and the power (float32, a root a start)
    written once."""
    starts = lanes * steps * HALF_FRAME * ROOTS
    ops = starts * (8 * SYMBOL + 3)
    nbytes = lanes * (steps * HALF_FRAME + SYMBOL) * 8 + starts * 4
    return roofline(ops, nbytes, PEAK_BF16 if bf16 else PEAK_F32)


def pass_b_bound(lanes: int, g: int, n_search: int) -> tuple[float, str]:
    """Least seconds for one pass-B group: the searched steps' power read
    once, the EMA and PSR ring read and written once, the rows written once,
    over the memory rate; ~6 float32 operations a searched bin (two
    products, a sum, the argmax, the lobe test, the side max), none of them
    an FMA, over the float32 rate of one operation an instruction."""
    nbytes = 4 * n_search * 9600 + 2 * 4 * lanes * 3 * (9600 + 200) \
        + 19 * g * lanes * 3
    return roofline(6 * n_search * 9600, nbytes)


def viterbi_bound(b: int, branch_ops: int) -> tuple[float, str]:
    """Least seconds for b tail-biting codewords of 40 bits: the float32
    operations the decode needs over the float32 rate of one operation an
    instruction (adds and compares, no FMA), against the LLRs read and the
    bits and metric written once over the memory rate.  A radix-4 step
    needs `branch_ops` adds for its distinct branch metrics, then 256
    candidate adds and 3 compares a state; the end takes 63 compares and a
    division."""
    return roofline(b * (60 * (branch_ops + 256 + 64 * 3) + 64),
                    b * (480 + 160 + 4))
