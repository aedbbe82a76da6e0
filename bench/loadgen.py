"""The one load generator: it reads a traffic mix (``bench/traffic/
<name>.json``) and turns it, with ``--seed``, into the requests a run
sends.

Every seed sends the same sizes in the same order. Lengths come in
blocks of ``block`` requests; each block holds the same set of prompt and
output lengths (the mid-points of ``block`` equal slices of each
distribution's probability) in an order drawn once from the block's
index, and the seed draws only the token ids. At a few clients the order
sets which requests run together, and so the work of a window: with the
order drawn from the seed, runs of different seeds spread several times
wider than two runs of one seed.

A closed loop (``"loop": "closed"``): ``clients`` workers each send their
next request when the last one completes, taking requests from one queue
in order. Token ids are uniform over the vocabulary (no two prompts share
a prefix); every request is greedy and runs to its ``max_new_tokens``."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

_SEED_MASK = (1 << 64) - 1


def stratified(dist: Dict, n: int) -> List[int]:
    """``n`` integer lengths at the mid-points of ``n`` equal probability
    slices of ``dist``: {"dist": "loguniform" | "uniform", "lo", "hi"},
    bounds inclusive."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if not 1 <= lo <= hi:
        raise ValueError(f"bad length range {dist}")
    us = [(k + 0.5) / n for k in range(n)]
    if dist["dist"] == "loguniform":
        out = [round(lo * math.exp(u * math.log(hi / lo))) for u in us]
    elif dist["dist"] == "uniform":
        out = [lo + int(u * (hi - lo + 1)) for u in us]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [min(hi, max(lo, x)) for x in out]


class Traffic:
    """Request ``i`` of a mix under ``seed``: its prompt token ids and its
    number of output tokens."""

    def __init__(self, spec: Dict, vocab_size: int, seed: int):
        if spec.get("loop") != "closed":
            raise ValueError(f"unsupported loop {spec.get('loop')!r}")
        self.clients = int(spec["clients"])
        self.block = int(spec["block"])
        self.vocab = int(vocab_size)
        self.seed = int(seed) & _SEED_MASK
        self.prompt_lens = stratified(spec["prompt_tokens"], self.block)
        self.output_lens = stratified(spec["output_tokens"], self.block)
        self._perms: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def sizes(self, i: int) -> Tuple[int, int]:
        """(prompt tokens, output tokens) of request ``i``."""
        b, j = divmod(i, self.block)
        perms = self._perms.get(b)
        if perms is None:
            rng = np.random.default_rng([0, b])
            perms = (rng.permutation(self.block), rng.permutation(self.block))
            self._perms[b] = perms
        return (self.prompt_lens[perms[0][j]], self.output_lens[perms[1][j]])

    def request(self, i: int) -> Tuple[List[int], int]:
        plen, olen = self.sizes(i)
        rng = np.random.default_rng([self.seed, 1, i])
        return rng.integers(0, self.vocab, size=plen).tolist(), olen
