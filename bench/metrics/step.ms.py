"""The window over the engine steps completed in it, in milliseconds.
Layer: the engine ring. Moves ``out_tok_s`` (one token a decode a
step)."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * run.window_s / len(run.steps)
