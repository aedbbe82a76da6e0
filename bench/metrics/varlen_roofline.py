"""The varlen flash kernel's share of its roofline over the traced
window: the least time its launches could take (the larger of FLOPs over
the bf16 peak and bytes over HBM bandwidth, counted from each traced
step's segments, positions and windows by ``bench.work.varlen``) over
their device time. Layer: the varlen flash kernel. Moves ``out_tok_s``."""
from bench.peaks import bound_seconds
from bench.work import varlen

KERNEL = "varlen_flash_kernel"


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    bound = 0.0
    for d in run.all_dispatches:
        if d.traced:
            bound += bound_seconds(*varlen(d.items, run.model))
    return 100.0 * bound / dev
