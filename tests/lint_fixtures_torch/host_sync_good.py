# Linted as serving/sampler.py — clean dispatch-path code.
import numpy as np
import torch


def prepare_step(tokens, x, lens, mask, flag, handle, device):
    up = torch.as_tensor(tokens).to(device, non_blocking=True)  # upload
    y = float(flag)                 # bare name: host scalar, fine
    z = bool(flag)
    pick = torch.where(mask, x, torch.zeros_like(x))    # elementwise where
    rep = x.repeat_interleave(2, dim=0)                 # host count
    ragged = torch.repeat_interleave(x, lens, output_size=8)
    host = np.flatnonzero(tokens)   # numpy on host data
    # jengalint: allow[host-sync] fetch phase: result row already on host
    out = handle.cpu()
    return up, y, z, pick, rep, ragged, host, out
