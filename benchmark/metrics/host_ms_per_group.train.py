"""Host milliseconds a group spends inside the multistep step's call
(static-input copies, generator seeding, the replay's launch), by the
harness's clock around each call with the metric read outside it, the
window's total over its groups."""


def read(run):
    c = run.counters
    if not c.get("groups"):
        return None
    return 1e3 * c["host_group_s"] / c["groups"]
