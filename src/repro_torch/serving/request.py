"""Serving-level request objects."""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from ..core import prefix_cache as pc
from ..core.request import MMItem, SequenceState


class Status(enum.Enum):
    WAITING = 0
    RUNNING = 1
    FINISHED = 2


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 = greedy
    top_k: int = 0                  # 0 = no truncation (temperature > 0 only)
    eos_token: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: str
    prompt: List[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    mm_items: Tuple[MMItem, ...] = ()
    encoder_items: Tuple[MMItem, ...] = ()
    status: Status = Status.WAITING
    arrival: float = 0.0
    seq: Optional[SequenceState] = None
    output: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    first_token_step: Optional[int] = None
    finished_step: Optional[int] = None
    # ---- routing metadata (multi-engine data-parallel serving) ----
    # True once the request has been part of a DISPATCHED plan on some
    # engine (device work exists / existed for it). A never-dispatched
    # request is trivially safe to pull off a shard and re-admit elsewhere:
    # there is no device state to lose and no output to deduplicate.
    started: bool = False
    # shard ids this request was placed on, in order (last = current);
    # >1 entry means the request survived a shard drain / failover.
    shard_history: List[int] = dataclasses.field(default_factory=list)
    # memoized prompt boundary-hash chains, keyed on (tokens_per_page,
    # salt) — the router probes every shard's prefix cache with the same
    # chains, so they are computed once per request, not once per probe.
    _route_hashes: Dict[tuple, list] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def make_seq(self) -> SequenceState:
        self.seq = SequenceState(
            rid=self.rid, tokens=list(self.prompt),
            mm_items=self.mm_items, encoder_items=self.encoder_items)
        return self.seq

    # ------------------------------------------------- routing hash chains
    def routing_keys(self) -> List[int]:
        """Per-position content keys of the PROMPT (text token ids, mm
        content keys) — the stream every shard's prefix-cache chains hash
        over. Memoized; prompts are immutable."""
        keys = self._route_hashes.get(("keys",))
        if keys is None:
            keys = pc.key_stream(self.prompt, self.mm_items)
            self._route_hashes[("keys",)] = keys
        return keys

    def prompt_boundary_hashes(self, tokens_per_page: int,
                               salt: int) -> List[int]:
        """Chain hash per FULL prompt page for a token-storage type with
        this page geometry — exactly the keys a shard's pool registers its
        pages under, so ``pool.lookup`` on these answers "does this shard
        hold my prefix"."""
        k = ("page", tokens_per_page, salt)
        h = self._route_hashes.get(k)
        if h is None:
            h = pc.page_chain_hashes(self.routing_keys(), tokens_per_page,
                                     salt)
            self._route_hashes[k] = h
        return h

    def prompt_state_hashes(self, interval: int,
                            salt: int) -> List[Tuple[int, int]]:
        """(position, chain-hash) at every state-checkpoint boundary inside
        the prompt — the keys state-type (mamba/rwkv) snapshot pages are
        registered under."""
        k = ("state", interval, salt)
        out = self._route_hashes.get(k)
        if out is None:
            out = []
            h = salt
            for i, key in enumerate(self.routing_keys()):
                h = pc.combine(h, key)
                if (i + 1) % interval == 0:
                    out.append((i + 1, h))
            self._route_hashes[k] = out
        return out

    # ------------------------------------------------------- re-admission
    def reset_for_routing(self) -> None:
        """Return to a fresh, unplaced state so another shard can admit the
        request from scratch. Any partial progress (sampled tokens, shard-
        local sequence state) is DISCARDED — greedy and the seeded
        temperature draws are deterministic in (rid, position), so a full
        recompute elsewhere reproduces the same output, which is what makes
        cross-shard failover exactly-once. The old shard must already have
        released the request's pages (``Engine.drain_requests``)."""
        self.status = Status.WAITING
        self.seq = None
        self.output = []
        self.started = False
        self.first_token_step = None
        self.finished_step = None

    @property
    def in_prefill(self) -> bool:
        return (self.seq is not None
                and self.seq.num_computed < len(self.prompt))

    @property
    def num_generated(self) -> int:
        return len(self.output)

    def is_done(self) -> bool:
        if self.num_generated >= self.sampling.max_new_tokens:
            return True
        eos = self.sampling.eos_token
        return eos is not None and self.output and self.output[-1] == eos
