"""Share of the training step's products spent on padding: one minus the
products at each question's own node, edge and token counts over the
products at the padded shapes of the batches that the program's
collators built, over the window's groups."""


def read(run):
    c = run.counters
    if not c.get("padded_flops"):
        return None
    return 100.0 * (1.0 - c["real_flops"] / c["padded_flops"])
