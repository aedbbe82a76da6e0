# Linted as serving/sampler.py — every call below blocks the host on the card.
import numpy as np
import torch


def prepare_step(logits, x, lens, mask, handle):
    a = logits.cpu()                        # forbidden: device fetch
    b = x.tolist()                          # forbidden
    c = x.item()                            # forbidden
    torch.cuda.synchronize()                # forbidden
    idx = mask.nonzero()                    # forbidden: data-dependent shape
    d = x.numpy()                           # forbidden
    e = x.to("cpu")                         # forbidden
    f = np.asarray(handle)                  # forbidden
    g = float(x.sum())                      # forbidden: non-trivial arg
    h = torch.unique(x)                     # forbidden
    i = x.masked_select(mask)               # forbidden
    j = x[x > 0]                            # forbidden: boolean mask
    k = torch.where(mask)                   # forbidden: one-argument where
    m = x.repeat_interleave(lens.long())    # forbidden: no output_size
    return a, b, c, idx, d, e, f, g, h, i, j, k, m
