"""Share of the pool's units referenced by running requests, averaged over
the window's steps (``StepMetrics.used_units`` over ``kv_pool_bytes`` / 2
bytes a unit). Layer: typed pools and the LCM allocator. Moves
``out_tok_s``: the pool bounds how many requests can run."""


def read(run):
    if not run.steps or not run.pool_units:
        return None
    used = sum(s.used_units for s in run.steps) / len(run.steps)
    return 100.0 * used / run.pool_units
