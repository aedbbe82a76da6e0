"""Host milliseconds a step spends scheduling, building its batch and
issuing its dispatch (``StepMetrics.host_build_ms + dispatch_issue_ms``),
averaged over the window's steps. Layer: the runner's host path. Moves
``out_tok_s`` where the host sets the pace."""


def read(run):
    if not run.steps:
        return None
    return sum(s.build_issue_ms for s in run.steps) / len(run.steps)
