"""The graph layers' share of their roofline: the least time of
``scene_graph_encoder`` + ``gat_seq``'s work at the traced requests' own
sizes (the larger of operations over 989 TFLOP/s and bytes over
3.35 TB/s), over the device time of the operations launched inside
those two modules' calls."""

from benchmark.readers import module_roofline
from benchmark.yardstick import graph_work


def read(run):
    return module_roofline(
        run, ("scene_graph_encoder", "gat_seq"),
        lambda cfg, b, s: graph_work(cfg, b, s[:, 0].sum(), s[:, 1].sum()))
