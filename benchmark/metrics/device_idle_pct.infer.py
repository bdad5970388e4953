"""Share of the traced sub-window in which no operation ran on the
device: one minus the union of the device operations' intervals over the
sub-window's length."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
