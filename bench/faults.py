"""Faults planted under the timed path, for showing that ``correct``
comes out false when the path is broken: a step that leaves its state
unchanged, half of the batch replaced by the mean over the rest, a token
altered where it is produced. (The cells run on one card: there is no
exchange between cards to leave out.)

Each fault takes ``set_attr(obj, name, value)`` (``setattr`` in a
calibration process, ``monkeypatch.setattr`` in a test) and the
configuration file's ``model`` section. The benchmark's own runs plant
none of them."""
from __future__ import annotations

from typing import Callable, Dict


def state_unchanged(set_attr: Callable, model: Dict) -> None:
    """The step's K/V rows are never written to the pages."""
    from repro_torch.models import attention as A
    set_attr(A, "write_kv_rows", lambda *a, **k: None)


def half_batch_mean(set_attr: Callable, model: Dict) -> None:
    """The second half of a step's logits rows replaced by the mean of the
    first half."""
    from repro_torch.models.lm import DecoderLM
    inner = DecoderLM.serve_step

    def broken(self, *a, **k):
        out = inner(self, *a, **k)
        n = out.shape[0]
        if n > 1:
            out = out.clone()
            out[n // 2:] = out[: n // 2].mean(0)
        return out

    set_attr(DecoderLM, "serve_step", broken)


def token_altered(set_attr: Callable, model: Dict) -> None:
    """Each greedy token moved to the next id of the vocabulary."""
    from repro_torch.serving import engine
    inner = engine.greedy_token
    vocab = model["vocab_size"]
    set_attr(engine, "greedy_token", lambda row: (inner(row) + 1) % vocab)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch_mean,
                                  token_altered)}
