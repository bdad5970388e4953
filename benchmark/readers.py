"""Shared arithmetic of the per-layer metric readers."""

from benchmark.harness import MODULE
from benchmark.yardstick import least_seconds


def module_roofline(run, modules, work):
    """The least time of the traced requests' work in ``modules`` (by
    ``work(config, questions, sizes) -> (flops, bytes)``) over the device
    time of the operations launched inside those modules' calls, in
    percent; None without a traced call."""
    tr = run.trace
    if tr is None:
        return None
    driver = run.driver
    device = {}
    for name, secs in tr.device_by_range(MODULE).items():
        mod, _, tag = name.partition("#")
        if mod in modules and tag.isdigit():
            device[int(tag)] = device.get(int(tag), 0.0) + secs
    least = spent = 0.0
    for r, secs in device.items():
        req = driver.requests.get(r)
        if req is None:
            continue
        sizes = driver.fx.sizes[req.key][req.batch]
        fl, nbytes = work(run.cell.config, len(sizes), sizes)
        least += least_seconds(fl, nbytes)
        spent += secs
    if spent <= 0:
        return None
    return 100.0 * least / spent
