"""Share of the traced window in which no operation ran on the device
(the complement of the union of its kernel, copy and set intervals).
Layer: the device. Moves ``out_tok_s``: an idle device waits on the
host."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
