"""Requests the scheduler holds running after each step of the window,
averaged (``len(engine.scheduler.running)``). Layer: scheduler and
manager. Moves ``out_tok_s``: more requests running, more tokens a step."""


def read(run):
    if not run.steps:
        return None
    return sum(s.running for s in run.steps) / len(run.steps)
