"""Host milliseconds a request spends inside the eval forward's call
(the enqueue, by the harness's clock around each call), the window's
total over its requests."""


def read(run):
    c = run.counters
    if not c.get("requests"):
        return None
    return 1e3 * c["host_forward_s"] / c["requests"]
