"""Model FLOPs of the tokens the window's untraced dispatches computed
(the benchmark's own count, ``bench.work.model_flops``) over that part of
the window times the card's bf16 peak, in percent. Layer: the model step. Moves
``out_tok_s``; it bounds every kernel's gain, since a kernel taken off the
path leaves its own roofline silent."""
from bench.peaks import PEAK_BF16_FLOPS
from bench.work import model_flops


def read(run):
    if not run.dispatches or run.window_s <= 0:
        return None
    flops = sum(model_flops(d.items, run.model) for d in run.dispatches)
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
