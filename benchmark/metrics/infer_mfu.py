"""The eval forward's products at the questions' own sizes, over the
window, as a share of the H100's dense bf16 peak (989 TFLOP/s)."""

from benchmark.yardstick import PEAK_FLOPS


def read(run):
    c = run.counters
    if not c.get("real_flops"):
        return None
    return 100.0 * c["real_flops"] / run.window_s / PEAK_FLOPS["bfloat16"]
