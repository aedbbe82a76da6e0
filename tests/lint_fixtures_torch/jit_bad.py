# Linted as kernels/step.py — impure compiled and captured functions.
import torch


def serve_step(params, x, n):
    print("tracing", x)                      # forbidden in a compiled fn
    if x > 0:                                # forbidden tensor branch
        x = x + 1
    return x * x.sum().item(), n             # forbidden host sync


step = torch.compile(serve_step)


def replay_body(x):
    return x.cpu()                           # forbidden under capture


def capture(graph, x):
    with torch.cuda.graph(graph):
        y = replay_body(x)
    return y
