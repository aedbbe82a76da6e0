# Linted as kernels/step.py — clean compiled function.
import torch


@torch.compile
def serve_step(params, x, *, prefill):
    if prefill:                              # kwonly: static flag idiom
        x = x * 2
    if x.shape[0] > 1:                       # .shape access is static
        x = x[:1]
    return torch.where(x > 0, x + 1, x)      # tensor branch done on device


def host_helper(x):
    print("not compiled, print is fine", x)
    if x > 0:
        return x + 1
    return x
