"""The text layers' share of their roofline: the least time of
``question_encoder`` + ``program_decoder``'s work at the traced requests'
own token counts (the larger of operations over 989 TFLOP/s and bytes
over 3.35 TB/s), over the device time of the operations launched inside
those two modules' calls."""

from benchmark.readers import module_roofline
from benchmark.yardstick import text_work


def read(run):
    return module_roofline(
        run, ("question_encoder", "program_decoder"),
        lambda cfg, b, s: text_work(cfg, b, s[:, 2].sum(),
                                    cfg["question_len"]))
