"""What one card takes of the reference's production mesh.

The reference runs every (arch x shape) cell on a 16 x 16 TPU mesh of axes
("data", "model") (``repro/launch/mesh.py``). The port has no mesh: it runs
on one card, and that card takes ONE data shard of the production mesh,
with the 16 tensor-parallel shards folded onto it (tp = 1). So it holds
every weight and ``global_batch / 16`` of the cell's sequences, each at
its full length.

A decode cell with ``global_batch < 32`` is sequence-parallel in the
reference (``sp``): its few sequences are split over the 16 data shards.
One card has no shard to split with, so ``sp`` cells follow a rule of their
own: the card holds every sequence of the cell, whole.
"""
from __future__ import annotations

import dataclasses

PRODUCTION_MESH = {"data": 16, "model": 16}


@dataclasses.dataclass(frozen=True)
class CardShare:
    rows: int          # sequences on the card
    tokens: int        # tokens of each sequence on the card
    sp: bool           # the reference runs the cell sequence-parallel
    cards: int         # cards that split the cell's global work (1 for sp)


def is_sp(shape) -> bool:
    """The reference's sequence-parallel rule (``launch/dryrun.py``)."""
    return shape.kind == "decode" and shape.global_batch < 32


def card_share(shape) -> CardShare:
    if is_sp(shape):
        return CardShare(shape.global_batch, shape.seq_len, True, 1)
    dp = PRODUCTION_MESH["data"]
    if shape.global_batch % dp:
        raise ValueError(f"{shape.name}: global batch {shape.global_batch} "
                         f"does not split over {dp} data shards")
    return CardShare(shape.global_batch // dp, shape.seq_len, False, dp)
