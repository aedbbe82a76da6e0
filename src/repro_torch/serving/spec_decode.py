"""Speculative decoding with a shared Jenga pool (paper §6.1, Fig. 19); a
copy of ``repro/serving/spec_decode.py`` whose two runners share one torch
buffer and one token board on one device.

Draft and target models register their KV types ("draft_*" / "tgt_*") in ONE
JengaKVCacheManager: the LCM geometry automatically accommodates the two
page sizes with negligible fragmentation — the paper's multi-model case.

Greedy speculative decoding: the draft proposes k tokens; the target scores
them; the longest agreeing prefix is accepted plus one bonus token;
rejected tokens roll back (pages stay, content is overwritten later).

PIPELINED ROUNDS (device sampling, no host round-trip inside a round):
every draft/verify step carries the fused sampling tail of
``ModelRunner.dispatch`` and lands its greedy pick in the shared token
board (``serving.sampler``), where the NEXT step's dispatch reads it back
on device (``board_feed``). One round issues the k-step draft chain, the
(k+1)-step verify chain, and — before fetching anything — the NEXT
round's draft chain speculated on full acceptance (its first token fed
from the bonus board slot). Only then does the host sync, once, on the
2k+1 sampled tokens concatenated on the device (4 bytes each, not
vocab-wide logits rows). On full
accept the pre-issued chain is reused (``overlapped_rounds``); otherwise
it is discarded and its trailing page allocations popped in one
round-level ``mgr.rollback_tokens`` (the dead dispatches still execute on
device, but they only write pages that are zeroed/overwritten by every
later owner — this is safe because every dispatch of both runners, and
every zeroing of a page's next owner, is issued on the one device's
current stream and runs in issue order).

Board slot layout per round (draft and verify runners share one board):
draft step j writes slot j (0..k-1); verify step j writes slot k+j
(k..2k); slot 2k is the bonus-on-full-accept the speculated next chain
consumes.

Both runners dispatch through the default token-packed plan layout:
each draft/verify call is a packed stream whose segments are the
participating sequences, and samples come back one per segment."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from .. import resolve_device
from ..core.manager import JengaKVCacheManager
from ..core.request import SequenceState
from .request import Request
from .runner import ModelRunner
from .sampler import greedy_token


@dataclasses.dataclass
class SpecDecodeConfig:
    k: int = 3                      # proposals per round
    kv_pool_bytes: int = 64 << 20
    chunk_size: int = 32
    geometry_mode: str = "lcm"      # "max" reproduces vLLM-max (Fig. 19)


class SpecDecodeEngine:
    """Single-sequence-at-a-time speculative decoding (functional case
    study; the throughput comparison in benchmarks uses allocator replay).

    Rounds are pipelined through the device token board — the host syncs
    once per round on sampled-token handles, and the next round's draft
    chain is already in flight when it does (see module docstring).
    Outputs are exactly the target model's tie-banded greedy trajectory
    regardless of draft quality: a proposal is only kept when it equals
    the target's own greedy pick at that position."""

    def __init__(self, target_model, draft_model, cfg: SpecDecodeConfig,
                 target_params=None, draft_params=None, seed=0,
                 device="cuda"):
        assert target_model.cfg.family in ("dense", "moe")
        assert draft_model.cfg.family == "dense"
        target_model.kv_prefix = "tgt_"
        draft_model.kv_prefix = "draft_"
        self.tm, self.dm = target_model, draft_model
        self.cfg = cfg
        specs = tuple(target_model.kv_specs()) + tuple(draft_model.kv_specs())
        self.mgr = JengaKVCacheManager(
            specs, total_memory_bytes=cfg.kv_pool_bytes,
            mode=cfg.geometry_mode,
            enable_prefix_caching=False)   # rollback requires caching off
        dev = resolve_device(device)
        self.t_runner = ModelRunner(target_model, self.mgr, device=dev)
        # shared pool: the draft runner is built on the target's buffer
        # (its scratch page is one page of every type, see ModelRunner)
        self.d_runner = ModelRunner(draft_model, self.mgr, device=dev,
                                    buffer=self.t_runner.buffer)
        self._shared_state()
        self.tp = target_params if target_params is not None \
            else target_model.init(seed, dev)
        self.dp = draft_params if draft_params is not None \
            else draft_model.init(seed + 1, dev)
        self.accept_lengths: List[int] = []
        # rounds whose draft chain was already in flight before the
        # previous round's accept decision reached the host
        self.overlapped_rounds = 0
        self.spec_rollback_pages = 0

    def _shared_state(self):
        """Both runners must see the same device buffer AND token board;
        wrap their dispatch entry points so each call picks up whatever
        the other runner last produced (the board is how a verify step
        consumes a draft step's sample without a host round-trip). The
        buffer is written in place and never rebound, but the board is
        reallocated when it grows (``ModelRunner._ensure_board``)."""
        t, d = self.t_runner, self.d_runner

        class _Shared:
            buffer = t.buffer
            board = t._board
        self._buf = _Shared

        def make_run(runner):
            orig = runner.run_plan

            def run_plan(params, items):
                runner.buffer = self._buf.buffer
                runner._board = self._buf.board
                out = orig(params, items)
                self._buf.buffer = runner.buffer
                self._buf.board = runner._board
                return out
            return run_plan

        def make_dispatch(runner):
            def dispatch_shared(params, items, **prep_kw):
                runner.buffer = self._buf.buffer
                runner._board = self._buf.board
                prep = runner.prepare(items, **prep_kw)
                handle = runner.dispatch(params, prep)
                self._buf.buffer = runner.buffer
                self._buf.board = runner._board
                return handle
            return dispatch_shared

        t.run_plan_shared = make_run(t)
        d.run_plan_shared = make_run(d)
        t.dispatch_shared = make_dispatch(t)
        d.dispatch_shared = make_dispatch(d)

    # ------------------------------------------------------------- chains
    def _draft_chain(self, dreq: Request, n0: int, k: int,
                     first_src: Optional[int] = None,
                     require: bool = True) -> Optional[list]:
        """Issue the k-step draft chain with no host sync: step j computes
        position ``n0 + j``; its input token is host-known (j == 0 with no
        ``first_src``), fed from board slot ``first_src`` (cross-round
        bonus), or fed from the previous step's sample slot; its own
        greedy sample lands in slot j. With ``require=False`` (speculative
        next-round chain) an allocation failure abandons the chain and
        pops what it already allocated."""
        dseq = dreq.seq
        handles = []
        for j in range(k):
            start = n0 + j
            if not self.mgr.allocate_for_tokens(dseq, start + 1):
                assert not require, ("draft chain allocation failed", start)
                self.spec_rollback_pages += self.mgr.rollback_tokens(
                    dseq, n0)
                return None
            src = first_src if j == 0 else j - 1
            handles.append(self.d_runner.dispatch_shared(
                self.dp, [(dreq, 1, start)],
                sample=True, board_feed=True, board_dst=[j],
                board_src=None if src is None else [src]))
        return handles

    def _verify_chain(self, treq: Request, base: int, k: int) -> list:
        """Issue the (k+1)-step verify chain: step j computes position
        ``base + j`` — token host-known for j == 0, fed from draft slot
        j-1 otherwise — and lands the target's greedy pick for position
        base+j+1 in slot k+j."""
        handles = []
        for j in range(k + 1):
            start = base + j
            assert self.mgr.allocate_for_tokens(treq.seq, start + 1)
            src = None if j == 0 else j - 1
            handles.append(self.t_runner.dispatch_shared(
                self.tp, [(treq, 1, start)],
                sample=True, board_feed=True, board_dst=[k + j],
                board_src=None if src is None else [src]))
        return handles

    def _fetch_round(self, d_handles: list, v_handles: list) -> List[int]:
        """The round's one host sync: each handle's single sampled token
        (the draft chain's, then the verify chain's), in order."""
        toks = torch.cat([h.tokens[:1] for h in d_handles + v_handles])
        self.d_runner.bytes_fetched += 4 * len(d_handles)
        self.t_runner.bytes_fetched += 4 * len(v_handles)
        # jengalint: allow[host-sync] fetch phase: the round's one host sync, 4 bytes a token
        return toks.cpu().tolist()

    # ------------------------------------------------------------ generate
    def generate(self, prompt: List[int], max_new_tokens: int = 16,
                 rid: str = "s0") -> List[int]:
        k = self.cfg.k
        # two SequenceStates share the same request id & token history
        tseq = SequenceState(rid=rid + "_t", tokens=list(prompt))
        dseq = SequenceState(rid=rid + "_d", tokens=list(prompt))
        for seq in (tseq, dseq):
            ok, _ = self.mgr.begin_request(seq)
            assert ok
        treq = Request(rid=rid + "_t", prompt=list(prompt)); treq.seq = tseq
        dreq = Request(rid=rid + "_d", prompt=list(prompt)); dreq.seq = dseq

        # prefill both (chunked); keep the TARGET's last logits
        t_last = None
        for seq, runner, params, req in ((tseq, self.t_runner, self.tp, treq),
                                         (dseq, self.d_runner, self.dp, dreq)):
            while seq.num_computed < len(prompt):
                n = min(self.cfg.chunk_size,
                        len(prompt) - seq.num_computed)
                assert self.mgr.allocate_for_tokens(
                    seq, seq.num_computed + n)
                logits = runner.run_plan_shared(params, [(req, n)])
                self.mgr.advance(seq, n)
            if seq is tseq:
                t_last = logits
        first = greedy_token(t_last[0][: self.tm.cfg.vocab_size])
        out = [first]
        tseq.append_token(first)
        dseq.append_token(first)

        # (pre-issued next-round draft chain, its n0) — valid only if the
        # current round fully accepts so the base lands where it assumed
        pending: Optional[Tuple[list, int]] = None
        while len(out) < max_new_tokens:
            # invariant at round start: tseq.tokens == dseq.tokens ==
            # prompt + accepted output, base = len(tokens) - 1 is the
            # position of the first unverified token
            base = tseq.num_computed
            assert len(dseq.tokens) == base + 1
            if pending is not None and pending[1] == base:
                d_handles = pending[0]
                self.overlapped_rounds += 1
            else:
                if pending is not None:     # reject made the guess stale
                    self.spec_rollback_pages += self.mgr.rollback_tokens(
                        dseq, base + 1)
                d_handles = self._draft_chain(dreq, base, k)
            pending = None
            v_handles = self._verify_chain(treq, base, k)
            # speculate full acceptance: issue round R+1's draft chain fed
            # from the bonus slot BEFORE the host learns round R's outcome
            base_next = base + k + 1
            if len(out) + k + 1 < max_new_tokens:
                nxt = self._draft_chain(dreq, base_next, k,
                                        first_src=2 * k, require=False)
                if nxt is not None:
                    pending = (nxt, base_next)

            # ---- single host sync for the round: the 2k+1 sampled
            # tokens, concatenated on the device and copied once
            toks = self._fetch_round(d_handles, v_handles)
            proposals, greedy = toks[:k], toks[k:]
            # materialize the draft chain the host never saw, then advance
            # both sequences to where their dispatched chains computed
            dseq.tokens = dseq.tokens[: base + 1] + proposals
            self.mgr.advance(dseq, base + k - dseq.num_computed)
            tseq.tokens = list(dseq.tokens[: base + k + 1])
            n_accept = 0
            while n_accept < k and proposals[n_accept] == greedy[n_accept]:
                n_accept += 1
            bonus = greedy[n_accept]
            accepted = proposals[:n_accept] + [bonus]
            self.accept_lengths.append(n_accept)
            out.extend(accepted)
            new_tokens = dseq.tokens[: base + n_accept + 1] + [bonus]
            self.mgr.advance(tseq, n_accept + 1)
            self.mgr.rollback(tseq, base + n_accept + 1, new_tokens)
            self.mgr.rollback(dseq, base + n_accept, new_tokens)
        if pending is not None:    # drained mid-speculation: pop its pages
            self.spec_rollback_pages += self.mgr.rollback_tokens(
                dseq, tseq.num_computed + 1)
        self.mgr.free_request(tseq, cache=False)
        self.mgr.free_request(dseq, cache=False)
        return out[:max_new_tokens]
