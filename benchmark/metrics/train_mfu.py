"""The training step's products (three times the forward's: each
product's two operand gradients) at the questions' own sizes, over the
window, as a share of the H100's dense bf16 peak (989 TFLOP/s)."""

from benchmark.yardstick import PEAK_FLOPS


def read(run):
    c = run.counters
    if not c.get("real_flops"):
        return None
    return (100.0 * 3.0 * c["real_flops"] / run.window_s
            / PEAK_FLOPS["bfloat16"])
