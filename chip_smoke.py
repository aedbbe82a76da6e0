#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Environment: the card's name and power limit, the torch/CUDA versions,
   and the build of every CUDA kernel from the sources in this checkout.
2. Each attention kernel against its plain PyTorch version on the card,
   at the main path's shapes (granite-3-2b: H=32, KVL=8, G=4, D=64, bf16;
   zamba2-1.2b's G=1 besides), with its
   time, the plain version's time, one library call's time where one
   exists and the least time the card could take for the same work: the
   varlen kernel on packed streams (mixed, decode, window, pad rows and
   dead slots, rows with no visible slot, G=1; the mixed and decode
   streams also in the serve path's token-major layout, held byte for
   byte against the head-major one; internlm2-1.8b's heads (D=128, G=2),
   qwen2.5-32b's (D=128, G=5) and the reduced configs' (D=16, G=2) on the
   mixed stream), each within TOL over rows with q_seg >= 0, exact zeros
   on rows with no visible slot, two calls byte-identical, with its
   device time, achieved TFLOP/s and share of the bound; every varlen
   instance's ptxas register/spill line and HGMMA count (the phase fails
   if one has none); the paged decode kernel on 8 rows of
   64-1056 tokens read from one layer of a 40-layer pool (window 64,
   invalid entries and pad rows, and qwen2.5-32b's D=128, G=5 besides),
   one 16,384-token row beside 7 decodes and 64 rows of 512-2048 tokens,
   each within TOL and two calls byte-identical, with its device time
   beside its time per back-to-back call and the wrapper's host time to
   issue one (the step's plan built once, as the serve path does), and
   every paged instance's ptxas register/spill line.
3. The main paths at full width: full granite-3-2b (random weights from
   seed 0) served by ``Engine`` with greedy sampling, in packed mode at
   pipeline depths 1, 2 and 4, in padded mode at depths 1, 2 and 4, and in
   serial mode, plus packed at a 256-token budget as a noise floor. Each
   leg must drain with no leaked page; outputs must be bitwise equal
   across the depths of a mode, and the padded and serial outputs
   fork-aware equal to packed depth 1 within twice that noise floor (the
   first-token logits' max difference between the two packed budgets; see
   phase 4 for the TIE_FORK_TOL bar at reduced size). Packed legs launch the
   varlen kernel once per layer of every dispatch; padded and serial legs
   launch the paged kernel once per layer of every T == 1 dispatch and
   the varlen kernel never.
4. A small reference: reduced granite-3-2b served on the card (kernels)
   and on the CPU (plain versions) with the same weights; greedy outputs
   of the card's packed, padded and serial engines must agree with the
   CPU's packed engine up to genuine near-ties (TIE_FORK_TOL).
5. Training (the dense training path, after phase 2b below has held its
   kernels against their plain version): full-width granite-3-2b trained
   4 steps by ``repro_torch.training.Trainer`` with fp32 masters (2 x 2048
   tokens per micro-batch, 2 micro-batches), finite losses and exact dense
   kernel launch counts, then one more step traced by ``torch.profiler``
   (device time by kernel group); reduced granite card vs CPU losses,
   exact resume from a checkpoint and the NaN watchdog.

Phase 5c, training across cards (the dense, MoE, VLM and hybrid families
on a ``(data, model)`` mesh over NCCL, ``repro_torch.launch.mesh``): (i)
full-width granite-3-2b at full depth through the mesh path at a 1 x 1
mesh, on phase 5's batch and weights, and qwen3-moe (1 layer),
qwen2-vl-2b (with its image batch) and zamba2-1.2b on phase 5b's weights,
batch and depth: the loss and every leaf's gradient norm equal to the
single-card path's bit for bit, exact kernel launch counts, the peak
held to the planner (granite: 2 timed steps beside phase 5's); (ii) where
2 or more cards are visible, one process a card, each mesh against a run
of the same function within MESH_TOLS: granite at MESH_CUT layers and
qwen2-vl-2b, 2 x 1 (2 x 2 with 4 cards) with FSDP and ZeRO-1 against one
card; zamba2-1.2b 2 x 1 against one card and 2 x 2 against 1 x 2 (its
out_norm runs over a rank's heads); qwen3-moe at one layer 2 x 1 (EP 2),
and 2 x 2 (EP 2 x expert-TP 2) against it (capacity and aux loss are
per data rank); with 4 cards qwen3-moe and dbrx-132b on 4 x 1 (EP 4) at
the planner's largest depth for it. Each card's step time, its peak
against the planner's per-card prediction and the bytes each collective
(the all-to-all among them) sends a step. With one card the phase prints
that leg (ii) was skipped and why.

Phase 5d, serving across cards (``phase_mesh_serve``): ``serve_step`` of
the dense, MoE, VLM and hybrid families on a ``(data, model)`` mesh over
NCCL, each rank's batch from ``launch.input_specs.split_batch`` of one
example batch (SERVE_STEPS: 8 requests mixed, 4 padded prefill rows, 8
decodes) over random K/V pages. (i) granite-3-2b at full depth (packed,
padded prefill, padded decode) and zamba2-1.2b (packed) on a 1 x 1 mesh:
logits and every buffer byte equal to the single-card step, the same
kernel launches. (ii) with 4 cards, one process a card: granite and
dbrx-132b (8 layers) 1 x 4 against one card (logits and written K/V
within MESH_SERVE_FLOOR_X times the noise floor: one card's distance from
itself with only the mesh's bf16 partial sums emulated, ``_tp_partials``;
greedy tokens equal or near ties; layer 0's K/V within
MESH_SERVE_KV0_ULPS); qwen2-vl-2b 1 x 4, K/V heads replicated twice,
against the same mesh with the attention's plain versions (the floor:
one card's kernels against their plain versions; its distance to one
card printed: the
reference's replica-group combine sums partials of different q heads);
dbrx-132b 1 x 4 at the planner's largest depth (40 layers), each rank's
own weights; qwen2.5-32b 2 x 2 sp decoding one sequence at
SP_ONE_CARD_LEN against one card and at the planner's longest length (up
to 524,288); zamba2-1.2b 2 x 2 against 1 x 2 (run on each data rank's
rows). Each rank's step ms, peak against the planner, bytes a step by
collective (the partial-attention combine among them) and kernel
launches. The log-sum-exp outputs of the
varlen and paged kernels that the combine reads are held against their
plain versions in ``phase_lse_kernels`` (after the paged phase), with
their device ms with and without the output.

Training the hybrid, VLM and MoE families (since the scan's backward
kernel): phase 2c also holds the scan's backward kernel
(``mamba_chunk_scan_bwd``, csrc/mamba_scan_bwd.cu) against its plain
version (autograd through the plain scan) at zamba2-1.2b's training shape
(2 rows of 2048, H = P = N = 64), on ragged rows and at the reduced
widths (H 8, P = N = 16) and on H 6 over a partial head group (P = N =
32): every gradient within MAMBA_BWD_TOL, repeatable bytes, dx, dB, dC
and ddt 0 outside rows, its time per call and each of its two launches'
device time beside the plain version's and the bound, every instance's
ptxas line and HGMMA count. Phase 5b trains full-width zamba2-1.2b,
qwen2-vl-2b (a seeded image span in every row) and qwen3-moe-235b-a22b
at full per-layer width (1 of 94 layers) 2 timed steps each from fp32 masters,
with exact scan and dense launch counts per micro-batch, ms per step,
tokens/s and peak memory, then their reduced configs card vs CPU and the
reduced hybrid's exact resume.

The hybrid path (since the Mamba2 chunk-scan kernel): phase 2c holds the
scan kernel against its plain version at zamba2-1.2b's widths (H 64, P 64,
N 64) on a packed mixed step, a packed decode step (non-zero initial
states, a killed segment as a zero-length row), a padded step (gaps
between rows), a 2048-token row beside 7 decodes (32 chained chunks) and
the reduced widths (P = N = 16): y and final states within MAMBA_TOL,
killed rows' states bit for bit, y exactly 0 outside rows, repeatable
bytes, the device time, the
wrapper's host time to issue a call, achieved TFLOP/s and share of the
bound, and every scan instance's ptxas line and HGMMA count (the phase
fails if an instance has none); phase 2 and the paged phase add
zamba2's G = 1 heads (the paged case at tokens_per_page 19). Phase 3b
serves full-width zamba2-1.2b (random weights from seed 0,
tokens_per_page 19, a pool of 4 large pages) with the 8 prompts of phase
3: packed at depths 1, 2 and 4 (bitwise equal, mamba launches ==
dispatches x 38), packed at a 256-token budget (noise floor), padded and
serial (fork-aware equal to packed within twice that floor), every leg
drained with no leaked page and state checkpoint copies made. Phase 3c
(``phase_max_geometry``) serves the same model under the MAX page
geometry (the paper's §4.4 baseline: every page padded to the 41.8 MB
Mamba state page), PageSan on: (a) at tokens_per_page 19, packed at
depths 1 and 4 and padded, bitwise equal to the LCM geometry at a pool
that holds the whole set in both; (b) at the published tokens_per_page
16, which the LCM geometry cannot hold on one card, packed and padded,
fork-aware equal to (a) within twice phase 3b's noise floor; (c) at
phase 3b's 8.02 GB pool, each geometry's most used units, requests
running, defers, preemptions and units lost to padding. The paged phase
reads zamba2's pages at that 41.8 MB stride (192 pages, an 8.0 GB
view), and phase 9 adds leg (d): speculative decoding with a 24-layer
draft whose page is not the target's, equal outputs, accept lengths,
draft proposals and draft logits under both geometries. Phase 4b serves reduced zamba2 on the card and on
the CPU.

Phase 2b holds the dense flash kernels (forward; backward dK/dV and dQ)
against their plain version at granite-3-2b's training shape (B=2, H=32,
KVL=8, D=64, T=S=2048, causal), with a window of 512, non-causal at
T=512, internlm2's heads (D=128, G=2) and a ragged T > S case: errors,
bitwise-repeatable gradients, times, achieved TFLOP/s and share of the
bound, bounds and one SDPA call's time; each kernel's device time at the
training shape; every instance's ptxas register/spill line, and its
tensor-core (HGMMA) instructions counted in the library's SASS (the phase
fails if a forward, dK/dV or dQ instance has none).

Head dim 120 (h2o-danube-3-4b; the D 128 kernel instances with the true
head dim at run time): phase 2, the paged phase and phase 2b add danube's
heads (varlen mixed, with and without window 64; paged decode, and a
6000-token row under window 4096; dense at window 512), each also run
with its output laid inside a buffer filled with a sentinel that must
survive past every stored row (varlen: columns 120-127 of every token-major
row; paged and dense: the elements past the end).

Seeded sampling (phase 3, after the greedy legs): full-width granite-3-2b
at temperature 0.8, top-k 50, seed 42, packed at depth 1 (sync,
``host_sample`` on the card), depth 2 (host), depth 2 with the fused
device tail and depth 4 (device tail), all byte-equal; seed 43 differs;
the CUDA launches and time of one fused tail over 8 sampled rows.

Phase 6, the rest of the dense family at full width (random bf16 weights
from seed 0, drawn on the card a layer at a time), each after the earlier
phases' memory is released: h2o-danube-3-4b (cut to 6 of its 24 layers
for time; d 3840, 32 / 8 heads of 120, window 4096 on every second
layer) with phase 3's first 6
prompts and 2 of 5,000-6,000 tokens, packed at depths 1 and 4, at budget
256, padded and serial, its SWA pages of the longest prompt at the end of
its prefill at most ceil(4096 / 16) + 1 while its full pages hold the
prompt; internlm2-1.8b (packed, budget 256, padded) and qwen2.5-32b
(65.5 GB of weights, the pool sized from the free memory; packed, budget
256, padded; 16 new tokens), with phase 3's checks: launch counts, no
leaked page, packed depths bitwise equal, padded and serial fork-aware
equal to packed within twice the noise floor.

Phase 7, the MoE family and the VLM backbone (each after the earlier
phases' memory is released): the expert products' fp32 route and a
reduced ``moe_block`` on the card against the CPU; qwen3-moe-235b-a22b at
5 of its 94 layers and dbrx-132b at 4 of its 40 (full per-layer width:
128 experts top-8 and 16 experts top-4; random bf16 weights from seed 0,
~27 and ~30 GB), one after the other, with phase 3's 8 prompts, a 4 GiB
pool and 32 new tokens: packed at depths 1 and 4 (fork-aware equal,
forks printed), packed at budget 256, padded, serial and a seeded packed
leg (temperature 0.8, top-k 50), with phase 3's launch and leak checks,
every dispatch's dropped (token, k) copies printed (qwen3-moe must drop
some: its decode capacity is 1) and the peak memory; then qwen2-vl-2b at
full width (28 layers, 12 / 2 heads of 128, QKV bias, M-RoPE) with 4 of
the prompts carrying a stub image of 64-256 positions (two sharing one):
packed at depths 1 and 4 (bitwise equal), budget 256 and padded, the
frontend run once per distinct image in every leg, and the image rows'
first-token logits moved by their images more than any text row's.
Phase 2 and the paged phase add the heads of these models: qwen3-moe's
G 16 (D 128, 64 / 4; varlen mixed and decode, paged), dbrx's and
qwen2-vl-2b's G 6 (48 / 8 and 12 / 2; varlen mixed, paged).

Phase 8, the enc-dec family and RWKV6 (each after the earlier phases'
memory is released): whisper-tiny at full width and depth (4 encoder +
4 decoder layers, d 384, 6 / 6 heads of 64, 1500 frames) with phase 3's
8 prompts, 6 of them carrying a stub clip of 1500 frames (two sharing
one) and 2 text-only: packed at depths 1 and 4 (bitwise equal), budget
256, padded and serial (fork-aware within twice the noise floor) and a
seeded packed leg; every leg runs the encoder once per distinct clip
(``encoder_runs`` 5) and launches the dense forward 4 times in each
dispatch that carries frames, the varlen kernel 8 times (self and cross
attention) in each packed dispatch and the paged kernel 4 times in each
padded T == 1 dispatch. Then rwkv6-3b at full width, cut to 4 of its 32
layers for time (d 2560, 40 heads of 64; plain torch, no attention
kernel),
packed at depths 1 and 4 (bitwise equal), budget 256, padded and serial,
with state checkpoint copies and no leaked page, and the CUDA launches
of one layer and of one packed mixed step (torch.profiler). Then both
reduced, card against CPU. Phase 2 adds whisper's self attention (G 1,
6 / 6 heads) and its cross attention over 8 segments x 1500 encoder
slots (two text-only, whose rows must be exact zeros) as a mixed and a
decode stream, the paged phase its G 1 heads and phase 2b its encoder
(BH 48, T = S = 1500 non-causal, and the serve call's S 1536).

Phase 9, speculative decoding, the data-parallel fleet and budget
autotuning on full-width granite-3-2b (random bf16 weights from seed 0),
after the earlier phases' memory is released. Spec legs: k 3 on phase 3's
first 2 prompts, 32 new tokens each, one request at a time, with draft
(a) the config cut to 4 layers with its own weights (seed 1; a smaller
page, mostly rejecting, so rounds roll pages back) and draft (b) the
target's config and weights under the ``draft_`` prefix (mostly
accepting, so pre-issued rounds are reused): outputs fork-aware equal to
the plain greedy engine on the same traffic within twice the noise floor
(the plain engine against the same requests batched), 0 used units after
every request, varlen launches == 40 x target dispatches + the draft's
layers x draft dispatches; accept lengths, ``overlapped_rounds`` and
``spec_rollback_pages`` printed. Fleet legs (2 GiB a pool; phase 3's 8
prompts, then 4 that share the first 512 tokens of r1, r0, r1 and r2; 16
new tokens): (i) a 1-shard fleet bitwise equal to the solo engine; (ii)
cache-aware against round-robin placement over 2 shards: more prefix-hit
tokens, outputs fork-aware equal to solo; (iii) roles prefill / decode:
zero prefill tokens on the decode shard, one handoff a request, every
adopted page byte-equal to its source page before the source releases
it; (iv) shard 1 crashed after 4 ticks: every request finished once,
fork-aware equal to (ii); each leg with one varlen launch a layer of
every dispatch and 0 used units on every shard. Then one engine packed
at depth 2 with ``autotune_budgets``: seed budget 288 (the H100's
roofline), its adjustments printed, fork-aware equal to solo.

Phase 10, Jenga against the PagedAttention baseline
(``memory_mode="paged-baseline"``) at full width, on the weights of
phases 6-8: h2o-danube-3-4b with phase 6's prompts (two of 5,000-6,000
tokens) and qwen2-vl-2b with phase 7's stub images run packed at depth 4
in both modes at their phase's pool (the baseline's peak used units above
Jenga's for danube, equal for qwen2-vl-2b, whose one KV type the baseline
treats as Jenga does), then packed at depth 4 and padded in both modes
under a pool of Jenga's peak plus 2%: Jenga holds all 8 requests with no
defer or preemption, the baseline defers or preempts (danube);
whisper-tiny with phase 8's clips packed at depth 1 and padded in both
modes at its phase's pool, its two text-only rows holding cross pages
under the baseline only. Every leg drains within a step cap with 0 leaked
pages, the baseline's outputs fork-aware equal to Jenga's within twice
the phase's noise floor; peak used units, the most requests running at
once, defers, preemptions and tokens/s are printed per leg.

Phase 11, the one-card fit planner (``repro_torch.launch.dryrun``):
every (arch x shape) predicted (weights, pool and activation terms,
whether it fits the card, its largest fitting depth, its roofline
terms), then granite-3-2b's ``prefill_32k`` (one packed dispatch of 2 x
32,768 tokens) and ``decode_32k`` (one padded T == 1 dispatch over 8 x
32,768 tokens) and zamba2-1.2b's ``train_4k`` (one ``Trainer`` step of 16
x 4096 tokens) run on the card, each peak within FIT_TOL of its
prediction. Every phase 5b training leg (rwkv6-3b now at 4 of its 32
layers) and every phase 6-8 serving model is also held to the planner's
prediction for its depth, batch and pool (the peak counted from before
its weights are drawn), and every depth cut of phases 5b-8 to the
planner's largest fitting depth. ``[time]`` lines give each phase's
seconds and the whole run's.

The last two lines of standard output are the kernels' JSON record and the
``{"ok": true, ...}`` line. Exits non-zero, printing no result, without a
CUDA device.
"""
from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16
# tensor-core FLOP/s; the bound assumes the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TOL = 2e-2          # bf16 output: a few ulps at |out| ~ 1, summed in another order
TIE_FORK_TOL = 2.5e-2
SENTINEL = 1 << 29
SENTINEL_BF16 = 12345.0     # exact in bf16; no output of the checks nears it


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel, iters=20, tries=5):
    """Mean device time of the CUDA kernels whose name contains
    ``kernel``, over the calls of ``fn`` in a ``torch.profiler`` window:
    the kernel's own time even where back-to-back calls are bound by the
    host's cost per call (which ``cuda_time_ms`` then measures). The
    window makes ``iters + 2`` calls. The profiler now and then hands
    back a window that lacks some or all of its device events (seen on
    the card: a window with none, one with 17 of 20, and windows one
    short): a window with fewer than ``iters`` or more than ``iters + 2``
    of them is taken again, up to ``tries`` times, and the call fails if
    none fits. The mean is over the launches the window recorded, which
    of the calls they were is not checked: every call of ``fn`` does the
    same work on the same inputs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters + 2):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key]
        n = sum(e.count for e in evs)
        if iters <= n <= iters + 2:
            return sum(_dev_us(e) for e in evs) / n / 1e3
        seen.append(n)
    raise AssertionError(f"profiler saw {seen} {kernel} launches in "
                         f"{tries} windows of {iters + 2} calls, never "
                         f"{iters} to {iters + 2}")


def _dev_us(e):
    return getattr(e, "device_time_total", None) or \
        getattr(e, "cuda_time_total", 0.0)


# ----------------------------------------------------------------- phase 1
@functools.lru_cache(maxsize=None)
def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_env():
    import torch
    from repro_torch.kernels import build
    smi = card()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build()
    log(f"[build] {len(logs)} kernel libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            entry = re.search(r"entry function .*?([a-z][a-z_]*_kernel)"
                              r"I((?:Li\d+E)+)", line)
            if entry:
                args = ",".join(re.findall(r"\d+", entry.group(2)))
                log(f"[ptxas {name}] {entry.group(1)}<{args}>:")
            elif "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    return smi


# ----------------------------------------------------------------- phase 2
def _case(name, segs, window=0, pad_rows=0, dead_slots=0, t_total=None,
          novis_segs=()):
    """Build one packed kernel call the way the serve path does: each
    segment is (old_slots, fresh_tokens, chunk_start); kv = old slots of
    every segment ++ the fresh tokens, pads at the end of the q stream.
    Fresh pad slots and ``dead_slots`` extra old slots carry seg -2;
    segments in ``novis_segs`` see no slot (their kv slots are dead)."""
    q_seg, q_pos, kv_seg, kv_pos = [], [], [], []
    for si, (old, fresh, start) in enumerate(segs):
        seg_kv = -2 if si in novis_segs else si
        kv_seg += [seg_kv] * old
        kv_pos += list(range(old))
        q_seg += [si] * fresh
        q_pos += list(range(start, start + fresh))
    kv_seg += [-2] * dead_slots
    kv_pos += [SENTINEL] * dead_slots
    t = t_total or len(q_seg) + pad_rows
    n_pad = t - len(q_seg)
    q_seg += [-1] * n_pad
    q_pos += [SENTINEL] * n_pad
    fresh_seg = [(-2 if s in novis_segs or s < 0 else s) for s in q_seg]
    kv_seg += fresh_seg
    kv_pos += q_pos
    return dict(name=name, window=window,
                q_seg=np.array(q_seg, np.int32), q_pos=np.array(q_pos, np.int32),
                kv_seg=np.array(kv_seg, np.int32),
                kv_pos=np.array(kv_pos, np.int32))


def _cross_case(name, fresh, text_only, t_total, enc_len=1500):
    """A packed cross-attention call as the enc-dec serve path builds it:
    segment si's tokens (``fresh[si]`` of them) see its own ``enc_len``
    encoder slots (kv_pos 0..enc_len-1) through ``q_pos := enc_lens - 1``;
    segments in ``text_only`` carry enc_lens 0, so q_pos -1 and no visible
    slot; pads (q_seg -1) likewise."""
    q_seg, q_pos, kv_seg, kv_pos = [], [], [], []
    for si, n in enumerate(fresh):
        q_seg += [si] * n
        q_pos += [-1 if si in text_only else enc_len - 1] * n
        kv_seg += [si] * enc_len
        kv_pos += list(range(enc_len))
    n_pad = t_total - len(q_seg)
    q_seg += [-1] * n_pad
    q_pos += [-1] * n_pad
    return dict(name=name, window=0,
                q_seg=np.array(q_seg, np.int32), q_pos=np.array(q_pos, np.int32),
                kv_seg=np.array(kv_seg, np.int32),
                kv_pos=np.array(kv_pos, np.int32))


def kernel_cases():
    # mixed step: a 256-token first chunk, a 200-token chunk over 512 old
    # slots and four decodes over 1024/896/768/896 slots -> 4096 old slots
    # + 512 fresh (460 real tokens, 52 pads)
    mixed = [(0, 256, 0), (512, 200, 512), (1024, 1, 1024), (896, 1, 896),
             (768, 1, 768), (896, 1, 896)]
    decode = [(511, 1, 511)] * 16                      # 16 decodes, S = 8192
    padded = [(0, 128, 0), (1024, 100, 1024), (2048, 1, 2048),
              (896, 1, 896)]
    # granite-3-2b's heads (H 32, KVL 8, D 64) unless a case says otherwise;
    # "token" cases lay q/k/v out as the serve path passes them (head-major
    # views of token-major tensors) and are held byte for byte against the
    # same values in contiguous head-major tensors
    return [
        _case("mixed T=512 S=4608", mixed, t_total=512),
        _case("decode T=16 S=8192", decode, t_total=16),
        _case("window=64 T=512 S=4608", mixed, window=64, t_total=512),
        _case("pad rows + dead slots T=512 S=4608", padded, t_total=512,
              dead_slots=4608 - 512 - 1024 - 2048 - 896),
        _case("no visible slot T=512 S=4608", mixed, t_total=512,
              novis_segs=(1, 3)),
        # zamba2-1.2b's shared attention: 32 kv heads for 32 q heads
        dict(_case("zamba2 G=1 mixed T=512 S=4608", mixed, t_total=512),
             kvl=32),
        dict(_case("mixed T=512 S=4608 token-major", mixed, t_total=512),
             layout="token"),
        dict(_case("decode T=16 S=8192 token-major", decode, t_total=16),
             layout="token"),
        # internlm2-1.8b's and qwen2.5-32b's heads (configs/archs.py)
        dict(_case("internlm2 heads D=128 G=2 mixed T=512", mixed,
                   t_total=512), h=16, kvl=8, d=128, layout="token"),
        dict(_case("qwen2.5-32b heads D=128 G=5 mixed T=512", mixed,
                   t_total=512), h=40, kvl=8, d=128, layout="token"),
        # the reduced configs' heads (phases 4 and 4b serve them)
        dict(_case("reduced heads D=16 G=2 mixed T=512", mixed,
                   t_total=512), h=4, kvl=2, d=16, layout="token"),
        # h2o-danube-3-4b's heads (D 120 on the D 128 instance), full and
        # sliding-window layers
        dict(_case("danube heads D=120 G=4 mixed T=512", mixed,
                   t_total=512), h=32, kvl=8, d=120, layout="token"),
        dict(_case("danube heads D=120 G=4 window=64 T=512", mixed,
                   window=64, t_total=512), h=32, kvl=8, d=120,
             layout="token"),
        # the MoE and VLM heads (phase 7): qwen3-moe's G 16 (4 tokens x 16
        # heads a warpgroup), dbrx's and qwen2-vl-2b's G 6 (10 tokens x 6
        # heads, 4 dead rows a warpgroup)
        dict(_case("qwen3-moe heads D=128 G=16 mixed T=512", mixed,
                   t_total=512), h=64, kvl=4, d=128, layout="token"),
        dict(_case("qwen3-moe heads D=128 G=16 decode T=16 S=8192", decode,
                   t_total=16), h=64, kvl=4, d=128, layout="token"),
        dict(_case("dbrx heads D=128 G=6 mixed T=512", mixed, t_total=512),
             h=48, kvl=8, d=128, layout="token"),
        dict(_case("qwen2-vl heads D=128 G=6 mixed T=512", mixed,
                   t_total=512), h=12, kvl=2, d=128, layout="token"),
        # whisper-tiny (phase 8): decoder self attention, 6 / 6 heads of 64;
        # cross attention over 8 segments x 1500 encoder slots, two of them
        # text-only (q_pos -1: exact zeros), as a mixed and a decode stream
        dict(_case("whisper self heads D=64 G=1 mixed T=512", mixed,
                   t_total=512), h=6, kvl=6, layout="token"),
        dict(_cross_case("whisper cross G=1 mixed T=512 S=12000",
                         (200, 150, 100, 40, 1, 1, 1, 1), (3, 6), 512),
             h=6, kvl=6, layout="token"),
        dict(_cross_case("whisper cross G=1 decode T=8 S=12000", (1,) * 8,
                         (3, 6), 8), h=6, kvl=6, layout="token"),
    ]


def _varlen_inputs(case, rng, dev):
    """q (H, T, D), k, v (KVL, S, D) bf16 from ``rng`` and the case's int32
    metadata on ``dev``; with layout "token" also the same values as the
    serve path lays them out (views of (T, H, D) and (S, KVL, D))."""
    import torch
    H, KVL, D = case.get("h", 32), case.get("kvl", 8), case.get("d", 64)
    t, s = len(case["q_seg"]), len(case["kv_seg"])
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                            device=dev)
               for shape in ((H, t, D), (KVL, s, D), (KVL, s, D)))
    meta = [torch.tensor(case[n], device=dev)
            for n in ("q_seg", "kv_seg", "q_pos", "kv_pos")]
    token = None
    if case.get("layout") == "token":
        token = [a.transpose(0, 1).contiguous().transpose(0, 1)
                 for a in (q, k, v)]
    return q, k, v, meta, token


def _sentinel_tail(out_fn, shape, dev):
    """Run ``out_fn(out)`` on an ``out`` of ``shape`` (contiguous bf16) laid
    at the start of a larger buffer filled with a sentinel, and check that
    the 64 elements past its end still hold it: a store of D 128 columns
    where the head dim is 120 runs 8 past the last row. Returns ``out``."""
    import torch
    n = int(np.prod(shape))
    buf = torch.full((n + 64,), SENTINEL_BF16, dtype=torch.bfloat16,
                     device=dev)
    out = buf[:n].view(shape)
    out_fn(out)
    torch.cuda.synchronize()
    if not bool((buf[n:] == SENTINEL_BF16).all()):
        raise AssertionError(f"a store ran past the end of {tuple(shape)}")
    return out


def _varlen_check(case, q, k, v, meta, token, kv_tiles):
    """One case's kernel output against the plain version over rows with
    q_seg >= 0, exact zeros on rows with no visible slot, two calls
    byte-identical, and (token layout) the serve layout's output equal to
    the head-major one byte for byte. Returns (err, visible mask)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_varlen, flash_attention_varlen_plain)
    dev = q.device
    w = case["window"]
    out_k = flash_attention_varlen(q, k, v, *meta, window=w,
                                   kv_tiles=kv_tiles)
    again = flash_attention_varlen(q, k, v, *meta, window=w,
                                   kv_tiles=kv_tiles)
    bare = flash_attention_varlen(q, k, v, *meta, window=w)
    out_p = flash_attention_varlen_plain(q, k, v, *meta, window=w)
    torch.cuda.synchronize()
    name = case["name"]
    if not (torch.equal(out_k, again) and torch.equal(out_k, bare)):
        raise AssertionError(f"{name}: two kernel calls differ")
    if token is not None:
        out_t = flash_attention_varlen(*token, *meta, window=w,
                                       kv_tiles=kv_tiles)
        torch.cuda.synchronize()
        if out_t.stride() != token[0].stride() or \
                not torch.equal(out_t, out_k):
            raise AssertionError(f"{name}: the token-major layout's output "
                                 "differs from the head-major one")
    H, t, D = q.shape
    if D == 120:
        # serve layout with the columns 120-127 of every (token, head) row
        # holding a sentinel: the kernel's D 128 instance must leave them
        buf = torch.full((t, H, 128), SENTINEL_BF16, dtype=torch.bfloat16,
                         device=dev)
        out_s = buf[:, :, :D].transpose(0, 1)
        flash_attention_varlen(*(token or (q, k, v)), *meta, window=w,
                               kv_tiles=kv_tiles, out=out_s)
        torch.cuda.synchronize()
        if not bool((buf[:, :, D:] == SENTINEL_BF16).all()) or \
                not torch.equal(out_s, out_k):
            raise AssertionError(f"{name}: the D 120 store wrote past column "
                                 "120 or differs from the plain call")
    qs, ks, qp, kp = (case[n] for n in ("q_seg", "kv_seg", "q_pos",
                                        "kv_pos"))
    mask = (ks[None, :] == qs[:, None]) & (kp[None, :] <= qp[:, None])
    if w:
        mask &= kp[None, :] > qp[:, None] - w
    valid = torch.tensor(qs >= 0, device=dev)
    err = (out_k.float() - out_p.float())[:, valid].abs().max().item()
    if not np.isfinite(err) or err > TOL:
        raise AssertionError(f"{name}: max abs err {err} > {TOL}")
    empty_t = torch.tensor(~mask.any(axis=1), device=dev)
    for label, out in (("kernel", out_k), ("plain", out_p)):
        if bool((out[:, empty_t] != 0).any()):
            raise AssertionError(f"{name}: {label} rows with no visible slot "
                                 "are not exactly 0")
    return err, mask


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_varlen, flash_attention_varlen_plain)
    from repro_torch.kernels.flash_attention.kernel import (varlen_kv_tiles,
                                                            varlen_plan)
    from repro_torch.serving.sampler import band_pick, greedy_token

    # every varlen instance must run its products on the tensor cores
    _build_facts("varlen_flash", "varlen_flash", 4, exempt=())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = []
    for case in kernel_cases():
        q, k, v, meta, token = _varlen_inputs(case, rng, dev)
        H, t, D = q.shape
        KVL, s = k.shape[:2]
        w = case["window"]
        # the serve path computes the skip metadata once per step
        kv_tiles = varlen_kv_tiles(meta[1], meta[3])
        err, mask = _varlen_check(case, q, k, v, meta, token, kv_tiles)
        tq, n_qt, ns = varlen_plan(t, s, H // KVL, KVL)
        args = token or (q, k, v)

        def kern():
            return flash_attention_varlen(*args, *meta, window=w,
                                          kv_tiles=kv_tiles)

        def plain():
            return flash_attention_varlen_plain(q, k, v, *meta, window=w)

        ms = device_ms(kern, "varlen_flash_kernel")
        call_ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain, iters=5)
        # yardstick only (never called by the port): SDPA with the same
        # boolean mask over K/V repeated to the q heads
        kr = k.repeat_interleave(H // KVL, dim=0)[None]
        vr = v.repeat_interleave(H // KVL, dim=0)[None]
        am = torch.tensor(mask, device=dev)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q[None], kr, vr, attn_mask=am))
        pairs = int(mask.sum()) * H
        flops = 4.0 * D * pairs
        nbytes = (2 * q.numel() + 2 * (k.numel() + v.numel())
                  + 4 * (2 * t + 2 * s) + 2 * q.numel())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        n_empty = int((~mask.any(axis=1)).sum())
        log(f"[kernel varlen_flash] {case['name']} H={H} KVL={KVL} D={D} "
            f"layout={case.get('layout', 'head')} q_tile={tq} tokens "
            f"x {n_qt}, splits<={ns} empty_rows={n_empty} max_abs_err="
            f"{err:.3e} (tol {TOL}, rows with q_seg >= 0) repeatable=True "
            f"ms={ms:.4f} (device time; {call_ms:.4f} per back-to-back "
            f"call) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.5f} ({by}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB) tflops={flops / ms / 1e9:.1f} "
            f"share_of_bound={bound / ms:.3f}")
        results.append(dict(case=case["name"], err=err, ms=ms,
                            call_ms=call_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound, bound_by=by))
        del q, k, v, kr, vr, token

    # the fused greedy tail picks what the host picks, bit for bit
    rows = rng.standard_normal((64, 49155)).astype(np.float32)
    for r in range(0, 64, 4):
        m = int(rows[r].argmax())
        rows[r, (m + 37) % 49155] = rows[r, m] - 0.5 * 5e-3
    dev_picks = band_pick(torch.tensor(rows, device=dev)).cpu().numpy()
    host_picks = np.array([greedy_token(x) for x in rows])
    if not np.array_equal(dev_picks, host_picks):
        raise AssertionError("device band_pick differs from greedy_token")
    log("[sampler] device band_pick == host greedy_token on 64 rows")
    return results


def paged_cases():
    """Decode batches as the padded serve path builds them: 8 rows whose
    query positions are 64-1056 (their pages, TPP 16 or 19, in a P=128 table
    padded with -1 / SENTINEL entries), the pages scattered over a pool of
    ``layers`` layers that the kernel reads one strided layer of; then one
    16,384-token row beside 7 of those decodes (P 2048) and 64 rows of
    512-2048 tokens (P 256), whose pools each call cycles through so that
    consecutive calls miss the 50 MB L2."""
    lens = np.random.default_rng(2).integers(64, 1057, 8)
    many = np.random.default_rng(4).integers(512, 2049, 64)
    short = np.random.default_rng(5).integers(64, 321, 8)
    return [
        dict(name="granite decode B=8 P=128", d=64, g=4, layers=40,
             lens=lens),
        dict(name="window=64", d=64, g=4, layers=40, lens=lens, window=64),
        dict(name="invalid entries + 2 pad rows", d=64, g=4, layers=40,
             lens=lens, invalid=True, pad=2),
        dict(name="qwen2.5-32b heads D=128 G=5", d=128, g=5, layers=8,
             lens=lens),
        # zamba2-1.2b's shared attention at tokens_per_page 19: G=1, one
        # layer of its 6-layer attention pool
        dict(name="zamba2 heads G=1 TPP=19", d=64, g=1, layers=6,
             lens=lens, kvl=32, tpp=19),
        # the same heads at the published TPP 16 under the MAX geometry:
        # each 0.79 MB attention page padded to the 41.8 MB Mamba state
        # page (a stride of 20,886,016 elements), 192 pages (phase 3b's
        # pool), so the view spans 8.0 GB (over 2^31 elements); the pad
        # is NaN, which the kernel must never read
        dict(name="zamba2 heads G=1 TPP=16 at the MAX stride (41.8 MB "
             "pages, VP 192)", d=64, g=1, layers=6, lens=short, kvl=32,
             tpp=16, stride=20_886_016, vp=192),
        dict(name="long row 16384 + 7 decodes P=2048", d=64, g=4, layers=40,
             lens=np.concatenate([[16384], lens[:7]]), p=2048),
        dict(name="64 rows of 512-2048 P=256", d=64, g=4, layers=8,
             lens=many, p=256),
        # h2o-danube-3-4b's heads: D 120 on the D 128 instance; its
        # sliding-window layers (window 4096) over a 6000-token row
        dict(name="danube heads D=120 G=4", d=120, g=4, layers=24,
             lens=lens),
        dict(name="danube D=120 window=4096 row 6000 + 7 decodes P=512",
             d=120, g=4, layers=24, lens=np.concatenate([[6000], lens[:7]]),
             p=512, window=4096),
        # the MoE and VLM heads (phase 7): G 16 takes two groups of 8 q
        # heads a block, G 6 one group of 6
        dict(name="qwen3-moe heads D=128 G=16", d=128, g=16, layers=10,
             lens=lens, kvl=4),
        dict(name="dbrx heads D=128 G=6", d=128, g=6, layers=8, lens=lens),
        dict(name="qwen2-vl heads D=128 G=6", d=128, g=6, layers=28,
             lens=lens, kvl=2),
        # whisper-tiny's decoder self attention (phase 8): G 1, 6 kv heads,
        # one layer of its 4-layer pool
        dict(name="whisper heads G=1 KVL=6 D=64", d=64, g=1, layers=4,
             lens=lens, kvl=6),
    ]


def paged_inputs(case, gen, rng, dev):
    """One case's kernel arguments: q, the pool (VP, layers, 2, TPP, KVL,
    D; with a ``stride``, a strided view of pages that many elements
    apart, the rest NaN), and int32 tables, page starts and positions on
    ``dev``, plus their numpy copies."""
    import torch
    B, P = len(case["lens"]), case.get("p", 128)
    D, G, L = case["d"], case["g"], case["layers"]
    KVL, TPP = case.get("kvl", 8), case.get("tpp", 16)
    n_pages = [int(n) // TPP + 1 for n in case["lens"]]
    vp = case.get("vp", sum(n_pages) + 1)
    if "stride" in case:
        from repro_torch.core.layout import PageView, page_rows, page_view
        page, stride = L * 2 * TPP * KVL * D, case["stride"]
        flat = torch.full((vp * stride,), float("nan"),
                          dtype=torch.bfloat16, device=dev)
        page_rows(flat, vp, stride, page).copy_(
            torch.randn((vp, page), generator=gen, device=dev))
        pool = page_view(flat, PageView((vp, L, 2, TPP, KVL, D), stride))
    else:
        pool = torch.randn((vp, L, 2, TPP, KVL, D), generator=gen,
                           device=dev).to(torch.bfloat16)
    tables = np.full((B, P), -1, np.int32)
    page_pos = np.full((B, P), SENTINEL, np.int32)
    positions = np.full((B,), SENTINEL, np.int32)
    perm = rng.permutation(vp)
    off = 0
    for b in range(B - case.get("pad", 0)):
        npg = n_pages[b]
        tables[b, :npg] = perm[off:off + npg]
        page_pos[b, :npg] = np.arange(npg) * TPP
        positions[b] = case["lens"][b]
        if case.get("invalid"):
            tables[b, 1], page_pos[b, 1] = -1, SENTINEL
        off += npg
    q = torch.randn((B, KVL, G, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    host = (tables, page_pos, positions)
    meta = [torch.tensor(a, device=dev) for a in host]
    return q, pool, meta, host


def phase_paged_kernel():
    """The paged decode kernel against its plain version on the card
    (``paged_cases``): every case within TOL, two calls byte-identical; its
    device time (``device_ms``) beside the time per back-to-back call and
    the wrapper's host time to issue one (the step's plan built once
    beforehand, as the serve path does), the plain version's time, gather +
    SDPA as a two-call yardstick and the bound; every instance's ptxas
    register/spill line and its mma.sync (HMMA) count (the phase fails if
    an instance has none)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_plan)

    _build_facts("paged_decode", "paged", 4, exempt=(), op="HMMA")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(3)
    results = []
    for case in paged_cases():
        w = case.get("window", 0)
        q, pool, meta, (tables, page_pos, positions) = paged_inputs(
            case, gen, rng, dev)
        B, P = tables.shape
        L, _, TPP, KVL, D = pool.shape[1:]
        G = q.shape[2]
        plan = paged_decode_plan(*meta, TPP, w)
        layer = [0]

        def view():
            # cycle over the pool's layers: each call reads other bytes,
            # as the serve step's 40 layers do, so timing meets a cold L2
            layer[0] = (layer[0] + 1) % L
            return pool[:, layer[0]]

        def kern():
            return paged_decode_attention(q, view(), *meta, window=w,
                                          plan=plan)

        def plain():
            return paged_decode_attention_plain(q, view(), *meta, window=w)

        kv = pool[:, L // 2]
        out_k = paged_decode_attention(q, kv, *meta, window=w)
        out_2 = paged_decode_attention(q, kv, *meta, window=w, plan=plan)
        out_p = paged_decode_attention_plain(q, kv, *meta, window=w)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_2):
            raise AssertionError(f"paged {case['name']}: two calls differ")
        if D == 120:
            out_s = _sentinel_tail(lambda o: paged_decode_attention(
                q, kv, *meta, window=w, plan=plan, out=o), q.shape, dev)
            if not torch.equal(out_s, out_k):
                raise AssertionError(f"paged {case['name']}: out= differs")
        err = (out_k.float() - out_p.float()).abs().max().item()
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"paged {case['name']}: max abs err {err}"
                                 f" > {TOL}")
        ms = device_ms(kern, "paged_decode_kernel")
        call_ms = cuda_time_ms(kern)
        host_ms = host_issue_ms(kern)
        plain_ms = cuda_time_ms(plain, iters=5)

        slot_pos = (page_pos[:, :, None] + np.arange(TPP)).reshape(B, -1)
        mask = slot_pos <= positions[:, None]
        if w:
            mask &= slot_pos > positions[:, None] - w
        mask_t = torch.tensor(mask[:, None, None, :], device=dev)

        def two_calls():
            # yardstick only (never called by the port): the gather and
            # SDPA with the same mask, two calls where the kernel is one
            pages = view().index_select(
                0, meta[0].clamp(min=0).reshape(-1).long()).view(
                    B, P, 2, TPP, KVL, D)
            k = pages[:, :, 0].reshape(B, P * TPP, KVL, D).transpose(1, 2)
            v = pages[:, :, 1].reshape(B, P * TPP, KVL, D).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q.reshape(B, KVL * G, 1, D), k, v, attn_mask=mask_t,
                enable_gqa=True)

        two_ms = cuda_time_ms(two_calls, iters=5)
        # bytes: each page with a visible slot read once (K and V of one
        # layer), q in and out, the int32 metadata; operations: QK^T and PV
        # for the G q heads of every kv head at every visible slot
        vis = mask.reshape(B, P, TPP).any(-1)
        seen = set(np.maximum(tables, 0)[vis].tolist())
        nbytes = (len(seen) * 2 * TPP * KVL * D * 2 + 2 * 2 * q.numel()
                  + 4 * (2 * B * P + B))
        flops = 4.0 * D * G * KVL * int(mask.sum())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        items = int((plan.work[:, 0] >= 0).sum())
        log(f"[kernel paged_decode] {case['name']} B={B} P={P} KVL={KVL} "
            f"G={G} D={D} TPP={TPP} pages/row={plan.count.tolist()} "
            f"work_items={items} "
            f"max_abs_err={err:.3e} (tol {TOL}) repeatable=True "
            f"ms={ms:.4f} (device time; {call_ms:.4f} per back-to-back "
            f"call, host_ms={host_ms:.4f} to issue one) plain_ms="
            f"{plain_ms:.4f} two_calls_ms={two_ms:.4f} (gather + SDPA) "
            f"bound_ms={bound:.5f} ({by}; {flops / 1e9:.4f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB, {int(mask.sum())} visible slots) "
            f"share_of_bound={bound / ms:.3f}")
        results.append(dict(case=case["name"], err=err, ms=ms,
                            call_ms=call_ms, host_ms=host_ms,
                            plain_ms=plain_ms, two_calls_ms=two_ms,
                            bound_ms=bound, bound_by=by))
        del pool, plan, out_k, out_2, out_p
    return results


LSE_TOL = 1e-3      # fp32 log-sum-exp: base-2 ex2.approx sums vs the plain natural log


def lse_varlen_cases():
    """The varlen kernel's log-sum-exp cases, at the rank heads of the
    serving meshes whose partials combine: qwen2-vl-2b at 1 x 4 (its 2
    K/V heads replicated twice: 3 q heads on 1 kv head a rank, D 128).
    Old slots only, as a replica group's member reads them (the fresh
    chunk is merged after the combine), with segments that see nothing
    (-inf); a mixed and a decode stream (the latter over split kv
    ranges)."""
    mixed = [(0, 256, 0), (512, 200, 512), (1024, 1, 1024), (896, 1, 896),
             (768, 1, 768), (896, 1, 896)]
    decode = [(511, 1, 511)] * 16
    rank = dict(h=3, kvl=1, d=128, layout="token")
    # whisper-tiny at 1 x 4: 6 MHA heads padded to 12, 3 q heads on 3 K/V
    # heads a rank (G 1, D 64), two replicas a K/V head
    whisper = dict(h=3, kvl=3, d=64, layout="token")
    return [dict(_case("qwen2-vl 1x4 rank G=3 mixed old-only T=512", mixed,
                       t_total=512, novis_segs=(0, 3)), **rank, old_only=True),
            dict(_case("qwen2-vl 1x4 rank G=3 decode old-only T=16 S=8176",
                       decode, t_total=16, novis_segs=(5,)), **rank,
                 old_only=True),
            dict(_case("whisper 1x4 rank KVL=3 G=1 D=64 mixed old-only "
                       "T=512", mixed, t_total=512, novis_segs=(0, 3)),
                 **whisper, old_only=True),
            dict(_case("whisper 1x4 rank KVL=3 G=1 D=64 decode old-only "
                       "T=16 S=8176", decode, t_total=16, novis_segs=(5,)),
                 **whisper, old_only=True)]


def lse_paged_cases():
    """The paged kernel's log-sum-exp cases: qwen2-vl-2b's 1 x 4 rank heads
    (KVL 1, G 3) over 8 rows, two of them a first token's strict old part
    (position -1 over no page: no visible slot, mean(V) and -inf), and
    qwen2.5-32b's 2 x 2 sp rank heads (KVL 4, G 5) over one
    262,144-token row, the half of a 524,288-token sequence one data rank
    holds (P 16,384, split over 64 blocks)."""
    lens = np.random.default_rng(2).integers(64, 1057, 8)
    return [dict(name="qwen2-vl 1x4 rank KVL=1 G=3 + 2 rows at position 0",
                 d=128, g=3, kvl=1, layers=28, lens=lens, pad=2,
                 first_token=True),
            dict(name="whisper 1x4 rank KVL=3 G=1 D=64 + 2 rows at "
                 "position 0", d=64, g=1, kvl=3, layers=4, lens=lens, pad=2,
                 first_token=True),
            dict(name="qwen2.5-32b 2x2 sp rank KVL=4 G=5 row 262144",
                 d=128, g=5, kvl=4, layers=1, lens=np.array([262143]),
                 p=16384)]


def _old_only(case):
    """A packed case's kv stream without its fresh part (the last T
    slots): what one member of a combine group reads."""
    t = len(case["q_seg"])
    return dict(case, kv_seg=case["kv_seg"][:-t], kv_pos=case["kv_pos"][:-t])


def _lse_err(lse_k, lse_p, label):
    """Max abs error of the kernel's log-sum-exp over the entries the plain
    version finds finite; the others must be -inf in both."""
    import torch
    fin = torch.isfinite(lse_p)
    if not torch.equal(torch.isfinite(lse_k), fin) or \
            bool((lse_k[~fin] != -torch.inf).any()):
        raise AssertionError(f"{label}: -inf rows differ from the plain "
                             "version's")
    err = (lse_k[fin] - lse_p[fin]).abs().max().item() if fin.any() else 0.0
    if not np.isfinite(err) or err > LSE_TOL:
        raise AssertionError(f"{label}: log-sum-exp err {err} > {LSE_TOL}")
    return err


def _efficient_lse_ms(q, k, v, mask):
    """Yardstick only (never called by the port): the ms of one
    ``torch.ops.aten._scaled_dot_product_efficient_attention`` call that
    computes the varlen call's output and its log-sum-exp, ``mask`` (T, S)
    as an additive bf16 bias (0 / -inf, its rows 16-aligned as the kernel
    wants) and each K/V head repeated for its G q heads."""
    import torch
    H, T, D = q.shape
    g = H // k.shape[0]
    s = k.shape[1]
    bias = torch.full((1, H, T, -(-s // 16) * 16), float("-inf"),
                      dtype=q.dtype, device=q.device)
    bias[..., :s].masked_fill_(torch.as_tensor(mask, device=q.device), 0.0)
    bias = bias[..., :s]
    q4 = q[None]
    k4, v4 = (a.repeat_interleave(g, 0)[None] for a in (k, v))
    return cuda_time_ms(lambda: torch.ops.aten.
                        _scaled_dot_product_efficient_attention(
                            q4, k4, v4, bias, True), iters=10)


def phase_lse_kernels():
    """The varlen and paged kernels' log-sum-exp output (the combine of
    partials on a serving mesh) against their plain versions: the output
    with it byte for byte the output without it, two calls byte-identical,
    the log-sum-exp within LSE_TOL and -inf exactly where the plain
    version's is; device ms with and without the output beside the plain
    version's ms and the bound (the output adds 4 bytes a row and head)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_varlen, flash_attention_varlen_plain)
    from repro_torch.kernels.flash_attention.kernel import varlen_kv_tiles
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_plan)
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    results = []
    for case in lse_varlen_cases():
        case = _old_only(case)
        q, k, v, meta, token = _varlen_inputs(case, rng, dev)
        H, t, D = q.shape
        kv_tiles = varlen_kv_tiles(meta[1], meta[3])
        args = token or (q, k, v)
        label = f"varlen lse {case['name']}"

        def kern(lse):
            return flash_attention_varlen(*args, *meta, kv_tiles=kv_tiles,
                                          return_lse=lse)

        bare = kern(False)
        out_k, lse_k = kern(True)
        out_2, lse_2 = kern(True)
        out_p, lse_p = flash_attention_varlen_plain(q, k, v, *meta,
                                                    return_lse=True)
        torch.cuda.synchronize()
        if not (torch.equal(bare, out_k) and torch.equal(out_k, out_2)
                and torch.equal(lse_k, lse_2)):
            raise AssertionError(f"{label}: outputs with and without the "
                                 "log-sum-exp, or two calls, differ")
        valid = torch.tensor(case["q_seg"] >= 0, device=dev)
        err = (out_k.float() - out_p.float())[:, valid].abs().max().item()
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"{label}: max abs err {err} > {TOL}")
        lerr = _lse_err(lse_k[:, valid], lse_p[:, valid], label)
        ms = device_ms(lambda: kern(True), "varlen_flash_kernel")
        ms0 = device_ms(lambda: kern(False), "varlen_flash_kernel")
        plain_ms = cuda_time_ms(lambda: flash_attention_varlen_plain(
            q, k, v, *meta, return_lse=True), iters=5)
        qs, ks, qp, kp = (case[n] for n in ("q_seg", "kv_seg", "q_pos",
                                            "kv_pos"))
        mask = (ks[None, :] == qs[:, None]) & (kp[None, :] <= qp[:, None])
        s = k.shape[1]
        lib_ms = _efficient_lse_ms(q, k, v, mask)
        flops = 4.0 * D * int(mask.sum()) * H
        nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())
                  + 4 * (2 * t + 2 * s) + 4 * H * t)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
            flops / BF16_FLOPS_PER_S else "operations"
        n_inf = int((~torch.isfinite(lse_p[:, valid])).sum())
        log(f"[kernel varlen_flash lse] {case['name']} H={H} D={D} S={s} "
            f"max_abs_err={err:.3e} lse_err={lerr:.3e} (tol {LSE_TOL}) "
            f"-inf rows={n_inf} same bytes without it=True ms={ms:.4f} "
            f"(device; {ms0:.4f} without the output) plain_ms="
            f"{plain_ms:.4f} bound_ms={bound:.5f} ({by}) library_ms="
            f"{lib_ms:.4f} (_scaled_dot_product_efficient_attention with "
            f"compute_log_sumexp, the mask as an additive bias)")
        results.append(dict(kernel="varlen", case=case["name"], err=err,
                            lse_err=lerr, ms=ms, ms_without=ms0,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                            library_ms=lib_ms))
        del q, k, v, token
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for case in lse_paged_cases():
        q, pool, meta, (tables, page_pos, positions) = paged_inputs(
            case, gen, rng, dev)
        if case.get("first_token"):
            positions[positions == SENTINEL] = -1
            meta[2] = torch.tensor(positions, device=dev)
        B, P = tables.shape
        TPP, KVL, D = pool.shape[3:]
        G = q.shape[2]
        kv = pool[:, 0]
        plan = paged_decode_plan(*meta, TPP, 0)
        label = f"paged lse {case['name']}"

        def kern(lse):
            return paged_decode_attention(q, kv, *meta, plan=plan,
                                          return_lse=lse)

        bare = kern(False)
        out_k, lse_k = kern(True)
        out_2, lse_2 = kern(True)
        out_p, lse_p = paged_decode_attention_plain(q, kv, *meta,
                                                    return_lse=True)
        torch.cuda.synchronize()
        if not (torch.equal(bare, out_k) and torch.equal(out_k, out_2)
                and torch.equal(lse_k, lse_2)):
            raise AssertionError(f"{label}: outputs with and without the "
                                 "log-sum-exp, or two calls, differ")
        err = (out_k.float() - out_p.float()).abs().max().item()
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"{label}: max abs err {err} > {TOL}")
        lerr = _lse_err(lse_k, lse_p, label)
        ms = device_ms(lambda: kern(True), "paged_decode_kernel")
        ms0 = device_ms(lambda: kern(False), "paged_decode_kernel")
        plain_ms = cuda_time_ms(lambda: paged_decode_attention_plain(
            q, kv, *meta, return_lse=True), iters=3)
        slot_pos = (page_pos[:, :, None] + np.arange(TPP)).reshape(B, -1)
        mask = slot_pos <= positions[:, None]
        vis = mask.reshape(B, P, TPP).any(-1)
        seen = set(np.maximum(tables, 0)[vis].tolist())
        nbytes = (len(seen) * 2 * TPP * KVL * D * 2 + 2 * 2 * q.numel()
                  + 4 * (2 * B * P + B) + 4 * B * KVL * G)
        flops = 4.0 * D * G * KVL * int(mask.sum())
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
            flops / BF16_FLOPS_PER_S else "operations"
        n_inf = int((~torch.isfinite(lse_p)).sum())
        log(f"[kernel paged_decode lse] {case['name']} B={B} P={P} "
            f"pages/row={plan.count.tolist()[:8]} max_abs_err={err:.3e} "
            f"lse_err={lerr:.3e} (tol {LSE_TOL}) -inf heads={n_inf} same "
            f"bytes without it=True ms={ms:.4f} (device; {ms0:.4f} without "
            f"the output) plain_ms={plain_ms:.4f} bound_ms={bound:.5f} "
            f"({by})")
        results.append(dict(kernel="paged", case=case["name"], err=err,
                            lse_err=lerr, ms=ms, ms_without=ms0,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=by))
        del pool, plan, q
    return results


# ---------------------------------------------------------------- phase 2c
MAMBA_TOL = 1e-3    # fp32 scan: max abs err over the largest |value|, sums in another order


def mamba_cases():
    """(name, row_start, row_len, TT, H, P, N) of scan calls as the zamba2
    serve path makes them, at zamba2-1.2b's widths (H 64, P 64, N 64)
    unless a case says otherwise: a packed mixed step (TT 512, 8 ragged
    segments, one killed in flight: length 0), a packed decode step (8
    one-token segments, one killed), a padded step (4 rows of T 256,
    ragged, gaps between rows), a long row (one 2048-token prefill beside 7
    decodes: 32 chunks chained), the packed mixed step at the reduced
    configs' widths (H 8, P 16, N 16; phase 4b serves them) and a rank's
    32 heads of zamba2's training micro-batch at tp 2 (2 rows of 2048)."""
    def packed(lens):
        return np.concatenate([[0], np.cumsum(lens)[:-1]]), lens

    mixed = [256, 150, 1, 1, 1, 60, 0, 30]
    return [
        ("packed mixed TT=512 R=8", *packed(mixed), 512, 64, 64, 64),
        ("packed decode TT=8 R=8", *packed([1, 1, 1, 0, 1, 1, 1, 1]), 8, 64,
         64, 64),
        ("padded B=4 T=256", np.arange(4) * 256, [256, 100, 1, 37], 1024, 64,
         64, 64),
        ("long row 2048 + 7 decodes", *packed([2048] + [1] * 7), 2055, 64,
         64, 64),
        ("reduced P=N=16 packed mixed", *packed(mixed), 512, 8, 16, 16),
        # a rank's heads of zamba2's training micro-batch on a tp 2 mesh
        ("zamba2 train per rank at tp 2: 2 x 2048, H 32", [0, 2048],
         [2048, 2048], 4096, 32, 64, 64),
    ]


def mamba_inputs(case, gen, dev):
    """One case's kernel arguments from ``gen``: x, B and C as the serve
    path passes them (views of one xbc row per token), dt after softplus,
    and non-zero initial states (a strided view of the per-row state, as
    the state pages hold it beside the conv state)."""
    import torch
    _, starts, lens, tt, H, P, N = case
    r, conv = len(lens), 3 * (H * P + 2 * N)
    xbc = (0.5 * torch.randn((tt, H * P + 2 * N), generator=gen,
                             device=dev)).to(torch.bfloat16)
    x = xbc[:, :H * P].view(tt, H, P)
    bm, cm = xbc[:, H * P:H * P + N], xbc[:, H * P + N:]
    dt = torch.nn.functional.softplus(
        torch.randn((tt, H), generator=gen, device=dev))
    a_log = 0.5 * torch.randn((H,), generator=gen, device=dev)
    flat = 0.3 * torch.randn((r, H * P * N + conv), generator=gen,
                             device=dev)
    s0 = flat[:, :H * P * N].view(r, H, P, N)
    rows = [torch.tensor(np.asarray(v), dtype=torch.int32, device=dev)
            for v in (starts, lens)]
    return (x, bm, cm, dt, a_log, *rows, s0)


def host_issue_ms(fn, calls=100, tries=3):
    """Host time to issue one call of ``fn``: the least over ``tries``
    runs of ``calls`` back-to-back calls before a synchronise (the way
    ``scripts/packed_step_time.py`` times the varlen wrapper)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return best


def _scan_work(lens, h, p, n, chunk=64):
    """FLOPs the scan needs on these rows: per head and chunk of l tokens,
    the causal (t, s) pairs' C.B and score @ x products, the state read
    and the state update."""
    flops = 0.0
    for ln in lens:
        for c0 in range(0, int(ln), chunk):
            l_ = min(chunk, int(ln) - c0)
            pairs = l_ * (l_ + 1) / 2
            flops += h * (pairs * (2 * n + 2 * p + 3) + l_ * 4 * p * n
                          + 2 * p * n)
    return flops


def phase_mamba_kernel():
    """The Mamba2 chunk-scan kernel against its plain version on the card
    (``mamba_cases``): outputs and final states within MAMBA_TOL, killed
    rows' states bit for bit, y exactly 0 outside every row, two calls
    giving the same bytes; the kernel's device time (``device_ms``), the
    time per back-to-back call, the wrapper's host time to issue a call,
    the plain version's time, the bound, achieved TFLOP/s and share of
    the bound; every instance's ptxas register/spill line and HGMMA count
    (the phase fails if one has none: every instance's chunk path runs its
    products on the tensor cores)."""
    import torch
    from repro_torch.kernels.mamba_scan import (
        mamba_chunk_scan_varlen, mamba_chunk_scan_varlen_plain)
    from repro_torch.kernels.mamba_scan.kernel import scan_blocks

    _build_facts("mamba_scan", "mamba_scan", 16, exempt=())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    results = []
    for case in mamba_cases():
        name, starts, lens, tt, H, P, N = case
        r = len(lens)
        args = mamba_inputs(case, gen, dev)
        s0 = args[-1]
        y, s1 = mamba_chunk_scan_varlen(*args)
        y2, s2 = mamba_chunk_scan_varlen(*args)
        ry, rs = mamba_chunk_scan_varlen_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(s1, s2)):
            raise AssertionError(f"mamba {name}: two calls differ")
        errs = []
        for label, a, b in (("y", y, ry), ("state", s1, rs)):
            e = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if not np.isfinite(e) or e > MAMBA_TOL * scale:
                raise AssertionError(f"mamba {name}: {label} max abs err {e}"
                                     f" > {MAMBA_TOL} x {scale}")
            errs.append((e, e / scale))
        for i, ln in enumerate(lens):
            if ln == 0 and not torch.equal(s1[i], s0[i]):
                raise AssertionError(f"mamba {name}: a zero-length row "
                                     "changed its state")
        inside = np.zeros(tt, bool)
        for st, ln in zip(starts, lens):
            inside[st:st + ln] = True
        if bool((y[torch.tensor(~inside, device=dev)] != 0).any()):
            raise AssertionError(f"mamba {name}: y is not 0 outside rows")

        def kern():
            return mamba_chunk_scan_varlen(*args)

        ms = device_ms(kern, "mamba_scan_kernel")
        call_ms = cuda_time_ms(kern)
        host_ms = host_issue_ms(kern)
        plain_ms = cuda_time_ms(lambda: mamba_chunk_scan_varlen_plain(*args),
                                iters=5)
        live = int(np.sum(lens))
        nbytes = (live * (H * P * 2 + 2 * N * 2 + H * 4) + H * 4 + 2 * r * 4
                  + 2 * r * H * P * N * 4 + tt * H * P * 4)
        flops = _scan_work(lens, H, P, N)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        blocks = scan_blocks(tt, r, H)
        log(f"[kernel mamba_scan] {name} H={H} P={P} N={N} rows="
            f"{list(map(int, lens))} blocks={blocks} y max_abs_err="
            f"{errs[0][0]:.3e} (rel {errs[0][1]:.2e}) state max_abs_err="
            f"{errs[1][0]:.3e} (rel {errs[1][1]:.2e}; tol {MAMBA_TOL}) "
            f"repeatable=True killed_rows_bitwise=True zero_outside_rows=True "
            f"ms={ms:.4f} (device time; {call_ms:.4f} per back-to-back call, "
            f"host_ms={host_ms:.4f} to issue one) plain_ms={plain_ms:.4f} "
            f"library_ms=none bound_ms={bound:.5f} ({by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB) "
            f"tflops={flops / ms / 1e9:.2f} share_of_bound={bound / ms:.3f}")
        results.append(dict(case=name, err=max(e for e, _ in errs), ms=ms,
                            call_ms=call_ms, host_ms=host_ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=by))
        del args, y, y2, s1, s2, ry, rs
    return results


# ------------------------------------------------------ phase 2c, backward
# the scan backward's gradients: bf16 ones (dx, dB, dC) within 2 bf16 ulps
# of the largest |value| (both sides round an fp32 sum in another order
# to bf16 once), fp32 ones (ddt, da_log) within 1e-4 of it
MAMBA_BWD_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}


def mamba_bwd_cases():
    """(name, row_start, row_len, TT, H, P, N) of scan-backward calls:
    zamba2-1.2b's training micro-batch (2 rows of 2048, H = P = N = 64),
    ragged rows (an empty one, a one-token one, rows ending mid-chunk,
    gaps) at zamba2's widths, the reduced configs' widths (H 8,
    P = N = 16) on ragged rows and on 40 rows, H 6 at P = N = 32, whose
    last head group (``kernel.HEAD_GROUP`` 4) holds 2 heads, and 48 rows
    of at most one chunk each at zamba2's widths, and a rank's 32 heads of
    the training micro-batch on a tp 2 mesh (2 rows of 2048)."""
    def packed(lens):
        return np.concatenate([[0], np.cumsum(lens)[:-1]]), lens

    return [
        ("zamba2 train 2 x 2048", [0, 2048], [2048, 2048], 4096, 64, 64, 64),
        ("ragged", [0, 300, 301, 700, 1800], [300, 0, 1, 1000, 47], 1900,
         64, 64, 64),
        ("reduced ragged", *packed([256, 150, 1, 0, 60, 45]), 512, 8, 16,
         16),
        # H 6 over head groups of 4 and 2 (P = N = 32): rows that end
        # mid-chunk in both groups, a gap and an empty row
        ("ragged across a head-group edge", [0, 70, 250, 250],
         [70, 129, 0, 45], 330, 6, 32, 32),
        # more than 32 rows: the work search's scan spans warps; rows of
        # at most 3 chunks, so launch A's units form one level
        ("40 rows", *packed([37 * i % 150 for i in range(40)]), 3232, 8,
         16, 16),
        # a packed batch of short sequences: every row at most one chunk,
        # so launch B's units form one level too
        ("48 rows of at most 64 tokens",
         *packed([23 * i % 65 for i in range(48)]), 1600, 64, 64, 64),
        # a rank's heads of the training micro-batch on a tp 2 mesh
        ("zamba2 train per rank at tp 2: 2 x 2048, H 32", [0, 2048],
         [2048, 2048], 4096, 32, 64, 64),
    ]


def _scan_bwd_work(lens, h, p, n, chunk=64):
    """FLOPs of the scan backward on these rows: per head and chunk of l
    tokens, the causal pairs' C.B, dy.x, score^T dy, dG B and dG^T C
    products, the l x P x N products of dS B, dS^T x, S_in^T dy and the
    two recomputed state passes."""
    flops = 0.0
    for ln in lens:
        for c0 in range(0, int(ln), chunk):
            l_ = min(chunk, int(ln) - c0)
            pairs = l_ * (l_ + 1) / 2
            flops += h * (2 * pairs * (2 * n + 2 * p) + 2 * l_ * p * n * 5)
    return flops


def phase_mamba_bwd_kernel():
    """The Mamba2 scan's backward kernel (``mamba_chunk_scan_bwd``)
    against its plain version (autograd through the plain scan) on the
    card (``mamba_bwd_cases``): every gradient within MAMBA_BWD_TOL, two
    calls giving the same bytes, dx, dB, dC and ddt 0 outside every row;
    the time per call (its two launches), each launch's device time under
    ``torch.profiler`` (A: the chunk states, B: the gradients and the
    sums), the plain version's time, the bound; every instance's ptxas
    register/spill line and HGMMA count (the phase fails if an instance
    has none: both launches run their products on the tensor cores)."""
    import torch
    from repro_torch.kernels.mamba_scan import (mamba_chunk_scan_bwd,
                                                mamba_chunk_scan_bwd_plain)
    from repro_torch.kernels.mamba_scan.kernel import HEAD_GROUP, bwd_plan

    _build_facts("mamba_scan_bwd", "mamba_bwd", 6, exempt=())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    results = []
    for case in mamba_bwd_cases():
        name, starts, lens, tt, H, P, N = case
        x, bm, cm, dt, a_log, rs, rl, _ = mamba_inputs(case, gen, dev)
        dy = torch.randn((tt, H, P), generator=gen, device=dev)
        args = (x, bm, cm, dt, a_log, rs, rl, dy)
        got = mamba_chunk_scan_bwd(*args)
        again = mamba_chunk_scan_bwd(*args)
        want = mamba_chunk_scan_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for label, a, b, c in zip(("dx", "dbm", "dcm", "ddt", "da_log"),
                                  got, again, want):
            if not torch.equal(a, b):
                raise AssertionError(f"mamba bwd {name}: {label}: two calls "
                                     "differ")
            tol = MAMBA_BWD_TOL[str(a.dtype).split(".")[-1]]
            e = (a.float() - c.float()).abs().max().item()
            scale = c.float().abs().max().item()
            if not np.isfinite(e) or e > tol * scale:
                raise AssertionError(f"mamba bwd {name}: {label} max abs err "
                                     f"{e} > {tol} x {scale}")
            errs.append(f"{label} {e:.3e} (rel {e / scale:.2e}, tol {tol:g})")
        inside = np.zeros(tt, bool)
        for st, ln in zip(starts, lens):
            inside[st:st + ln] = True
        out = torch.tensor(~inside, device=dev)
        for label, a in zip(("dx", "dbm", "dcm", "ddt"), got[:4]):
            if bool((a[out] != 0).any()):
                raise AssertionError(f"mamba bwd {name}: {label} not 0 "
                                     "outside rows")

        def kern():
            return mamba_chunk_scan_bwd(*args)

        ms = cuda_time_ms(kern, iters=10)
        dev_a = device_ms(kern, "mamba_bwd_states_kernel")
        dev_b = device_ms(kern, "mamba_bwd_chunk_kernel")
        plain_ms = cuda_time_ms(lambda: mamba_chunk_scan_bwd_plain(*args),
                                iters=3, warmup=1)
        live = int(np.sum(lens))
        # x, B, C, dt and dy read once; dx, dB, dC (bf16), ddt and da_log
        # written once
        nbytes = live * (H * P * 2 + 2 * N * 2 + H * 4 + H * P * 4) + \
            live * (H * P * 2 + 2 * N * 2 + H * 4) + 2 * H * 4 + \
            2 * len(lens) * 4
        flops = _scan_bwd_work(lens, H, P, N)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        plan = bwd_plan(tt, len(lens), H, P, N)
        log(f"[kernel mamba_scan_bwd] {name} H={H} P={P} N={N} rows="
            f"{list(map(int, lens))} blocks A={plan.blocks_a} B="
            f"{plan.blocks_b} (head groups of {HEAD_GROUP}): max abs err "
            f"{'; '.join(errs)}; repeatable=True zero_outside_rows=True "
            f"(dx, dB, dC, ddt) ms={ms:.4f} (per call, 2 launches; device "
            f"ms A={dev_a:.4f} B={dev_b:.4f}) plain_ms={plain_ms:.4f} "
            f"library_ms=none (no single call) bound_ms={bound:.5f} ({by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB) "
            f"share_of_bound={bound / ms:.4f} [{card()}]")
        results.append(dict(case=name, err=max(
            (a.float() - c.float()).abs().max().item()
            for a, c in zip(got, want)), ms=ms, device_a_ms=dev_a,
            device_b_ms=dev_b, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by))
        del args, got, again, want
    return results


# ---------------------------------------------------------------- phase 2b
GRAD_TOL = 1e-2     # dQ/dK/dV: max abs err over the largest |gradient|


def dense_cases():
    """(name, B, H, KVL, D, T, S, causal, window): granite-3-2b's training
    shape, its window and non-causal variants, internlm2's heads (D 128,
    G 2), a ragged case whose T > S + window - 1 tail rows see nothing
    (their output is mean(V)), danube's heads and whisper-tiny's serving
    and training calls."""
    return [
        ("granite train T=2048 causal", 2, 32, 8, 64, 2048, 2048, True, 0),
        ("window=512 T=2048", 2, 32, 8, 64, 2048, 2048, True, 512),
        ("causal=False T=512", 2, 32, 8, 64, 512, 512, False, 0),
        ("internlm2 heads D=128 G=2 T=2048", 2, 16, 8, 128, 2048, 2048,
         True, 0),
        ("ragged T=333 S=200 window=50 D=32", 1, 4, 2, 32, 333, 200, True,
         50),
        # h2o-danube-3-4b's heads (D 120 on the D 128 instances), its
        # sliding-window layers' mask at a window T/4
        ("danube heads D=120 G=4 T=2048 window=512", 1, 32, 8, 120, 2048,
         2048, True, 512),
        # whisper-tiny's encoder (phase 8): 8 rows x 6 heads of 64, 1500
        # frames, non-causal; the serve path's call also attends the
        # reference's 36 zero pad keys (S 1536, ``encdec.ENC_KV_BLOCK``)
        ("whisper encoder BH=48 T=S=1500 non-causal", 8, 6, 6, 64, 1500,
         1500, False, 0),
        ("whisper encoder serve call BH=48 T=1500 S=1536 non-causal", 8, 6,
         6, 64, 1500, 1536, False, 0),
        # whisper-tiny's training (phase 5b: 8 rows a micro-batch, 448
        # decoder tokens): the encoder's call is the serve call above; the
        # decoder's causal self attention at S = T and its cross attention
        # over the padded 1536 encoder keys
        ("whisper decoder self BH=48 T=S=448 causal", 8, 6, 6, 64, 448, 448,
         True, 0),
        ("whisper cross BH=48 T=448 S=1536 non-causal", 8, 6, 6, 64, 448,
         1536, False, 0),
        # whisper-tiny trained on a 2 x 2 mesh (phase 5c (ii)): a rank's 3
        # heads (6 over tp 2) of its 4 rows of a micro-batch (8 over dp 2)
        ("whisper 2x2 rank encoder BH=12 T=1500 S=1536 non-causal", 4, 3, 3,
         64, 1500, 1536, False, 0),
        ("whisper 2x2 rank decoder self BH=12 T=S=448 causal", 4, 3, 3, 64,
         448, 448, True, 0),
        ("whisper 2x2 rank cross BH=12 T=448 S=1536 non-causal", 4, 3, 3, 64,
         448, 1536, False, 0),
    ]


def _build_facts(lib_name, prefix, n_instances, exempt, op="HGMMA"):
    """A kernel library's ptxas register/spill line of every kernel
    instance (``<prefix>_..._kernel<args>``, named by all its template
    arguments) and the tensor-core instructions of each in its SASS
    (``cuobjdump -sass``): ``op`` is HGMMA for wgmma, HMMA for mma.sync.
    Raises unless there are ``n_instances`` and each whose name holds no
    word of ``exempt`` has such instructions: a silent fall back to
    CUDA-core FMAs cannot pass."""
    import shutil
    from repro_torch.kernels import build
    lib = build.library_path(lib_name)
    pat = rf"({prefix}_[a-z_]*kernel)I((?:Li\d+E)+)"

    def instance(m):
        args = ",".join(re.findall(r"\d+", m.group(2)))
        return f"{m.group(1)}<{args}>"

    name, regs = None, {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        entry = re.search(r"entry function .*?" + pat, line)
        if entry:
            name = instance(entry)
        elif name and ("registers" in line or "spill" in line):
            regs[name] = (regs.get(name, "") + " " + line.split(":")[-1]
                          .strip()).strip()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hgmma, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : .*?" + pat, line)
        if fn:
            name = instance(fn)
            hgmma[name] = 0
        elif name and re.search(rf"\b{op}\b", line):
            hgmma[name] += 1
    for name in sorted(set(regs) | set(hgmma)):
        log(f"[kernel {lib_name}] {name}: {regs.get(name, '?')}; "
            f"{hgmma.get(name, 0)} {op} instructions in its SASS")
    missing = [n for n in hgmma
               if not any(x in n for x in exempt) and not hgmma[n]]
    if len(hgmma) != n_instances or missing:
        raise AssertionError(f"{lib_name} SASS: {op} counts {hgmma}; "
                             f"instances without tensor-core products: "
                             f"{missing}")


def _dense_build_facts():
    """The dense library's facts (``_build_facts``): a forward, dK/dV or dQ
    instance without HGMMA instructions fails; the delta pre-pass has
    none by design."""
    _build_facts("dense_flash", "dense", 16, exempt=("delta",))


def phase_dense_kernel():
    """The dense flash kernels against their plain version on the card:
    forward output and dQ/dK/dV, bitwise-repeatable backward, times,
    achieved TFLOP/s and share of the bound, one SDPA call as the library
    yardstick; the instances' ptxas lines and HGMMA counts."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        dense_flash_attention, dense_flash_bwd, dense_flash_fwd,
        flash_attention_plain)
    from repro_torch.kernels.flash_attention.dense import dense_mask

    _dense_build_facts()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    results = []
    for name, B, H, KVL, D, T, S, causal, w in dense_cases():
        BH, KVH = B * H, B * KVL

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)

        q, k, v, dout = rnd(BH, T, D), rnd(KVH, S, D), rnd(KVH, S, D), \
            rnd(BH, T, D)
        kw = dict(causal=causal, window=w)
        out, lse = dense_flash_fwd(q, k, v, **kw)
        grads = dense_flash_bwd(q, k, v, out, lse, dout, **kw)
        again = dense_flash_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
        if not bitwise:
            raise AssertionError(f"dense {name}: two backward calls differ")
        if D == 120:
            o_s = _sentinel_tail(lambda o: dense_flash_fwd(q, k, v, out=o,
                                                           **kw),
                                 q.shape, dev)
            g_s = [_sentinel_tail(lambda o, i=i: dense_flash_bwd(
                q, k, v, out, lse, dout, grads=[
                    o if j == i else torch.empty_like(a)
                    for j, a in enumerate((q, k, v))], **kw), a.shape, dev)
                for i, a in enumerate((q, k, v))]
            if not (torch.equal(o_s, out) and
                    all(torch.equal(a, b) for a, b in zip(g_s, grads))):
                raise AssertionError(f"dense {name}: out=/grads= differ")
        leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
        ref = flash_attention_plain(*leaves, **kw)
        ref_grads = torch.autograd.grad(ref, leaves, dout)
        err = (out.float() - ref.float()).abs().max().item()
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"dense {name}: forward max abs err {err} "
                                 f"> {TOL}")
        gerr, grel = [], []
        for label, a, b in zip("qkv", grads, ref_grads):
            e = (a.float() - b.float()).abs().max().item()
            scale = max(1.0, b.float().abs().max().item())
            if not np.isfinite(e) or e > GRAD_TOL * scale:
                raise AssertionError(f"dense {name}: d{label} max abs err {e}"
                                     f" > {GRAD_TOL} x {scale}")
            gerr.append(e)
            grel.append(e / scale)
        # the autograd route gives the same bytes as the direct calls
        if name.startswith("granite"):
            lv = [a.detach().requires_grad_(True) for a in (q, k, v)]
            o2 = dense_flash_attention(*lv, **kw)
            g2 = torch.autograd.grad(o2, lv, dout)
            if not (torch.equal(o2, out) and
                    all(torch.equal(a, b) for a, b in zip(g2, grads))):
                raise AssertionError("dense: autograd route differs from the"
                                     " direct kernel calls")
        del ref, ref_grads, leaves

        ms = cuda_time_ms(lambda: dense_flash_fwd(q, k, v, **kw), iters=10)
        bwd_ms = cuda_time_ms(
            lambda: dense_flash_bwd(q, k, v, out, lse, dout, **kw), iters=10)

        plain_ms = cuda_time_ms(
            lambda: flash_attention_plain(q, k, v, **kw), iters=3, warmup=1)
        lv = [a.detach().requires_grad_(True) for a in (q, k, v)]
        ref = flash_attention_plain(*lv, **kw)
        plain_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            ref, lv, dout, retain_graph=True), iters=3, warmup=1)
        del ref, lv
        # yardstick only (never called by the port): one SDPA call
        sq = q.view(B, H, T, D)
        sk, sv = k.view(B, KVL, S, D), v.view(B, KVL, S, D)
        mask = dense_mask(T, S, causal, w, dev)
        sd = dict(is_causal=True) if causal and not w and T == S else \
            dict(attn_mask=mask)
        lv = [a.detach().requires_grad_(True) for a in (sq, sk, sv)]
        lib_out = F.scaled_dot_product_attention(*lv, enable_gqa=True, **sd)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, enable_gqa=True, **sd), iters=10)
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, lv, dout.view(B, H, T, D), retain_graph=True), iters=10)
        del lib_out, lv

        pairs = int(mask.sum().item()) * BH
        el = 2 * (q.numel() + k.numel() + v.numel())     # bf16 q, k, v
        fwd_bytes = el + 2 * q.numel() + 4 * BH * T      # + out, lse
        bwd_bytes = el + 2 * 2 * q.numel() + 4 * BH * T + el  # + out, dO, lse; dq dk dv
        bounds = []
        for nbytes, flops in ((fwd_bytes, 4.0 * D * pairs),
                              (bwd_bytes, 10.0 * D * pairs)):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            bounds.append((max(t_bytes, t_ops),
                           "bytes" if t_bytes >= t_ops else "operations"))
        fwd_tflops = 4.0 * D * pairs / (ms * 1e-3) / 1e12
        bwd_tflops = 10.0 * D * pairs / (bwd_ms * 1e-3) / 1e12
        log(f"[kernel dense_flash] {name} fwd max_abs_err={err:.3e} (tol "
            f"{TOL}) dq/dk/dv max_abs_err={gerr[0]:.3e}/{gerr[1]:.3e}/"
            f"{gerr[2]:.3e} (rel to max {max(grel):.2e}, tol {GRAD_TOL}) "
            f"bwd bitwise repeatable={bitwise} fwd_ms={ms:.4f} "
            f"bwd_ms={bwd_ms:.4f} plain_fwd_ms={plain_ms:.4f} "
            f"plain_bwd_ms={plain_bwd_ms:.4f} "
            f"sdpa_fwd_ms={lib_ms:.4f} sdpa_bwd_ms={lib_bwd_ms:.4f} "
            f"bound_fwd_ms={bounds[0][0]:.5f} ({bounds[0][1]}) "
            f"bound_bwd_ms={bounds[1][0]:.5f} ({bounds[1][1]}; "
            f"{pairs / 1e6:.1f} M visible pairs) fwd_tflops={fwd_tflops:.1f} "
            f"bwd_tflops={bwd_tflops:.1f} (10 D FLOPs per pair) "
            f"fwd_share_of_bound={bounds[0][0] / ms:.3f} "
            f"bwd_share_of_bound={bounds[1][0] / bwd_ms:.3f}")
        if name.startswith("granite"):
            # device time of each kernel: forward; delta, dK/dV, dQ
            def bwd():
                return dense_flash_bwd(q, k, v, out, lse, dout, **kw)
            parts = {"fwd": device_ms(lambda: dense_flash_fwd(q, k, v, **kw),
                                      "dense_fwd_kernel", iters=10)}
            for part in ("delta", "dkv", "dq"):
                parts[part] = device_ms(bwd, f"dense_{part}_kernel", iters=10)
            log(f"[kernel dense_flash] {name} device ms: " + " ".join(
                f"{part}={t:.4f}" for part, t in parts.items()))
        results.append(dict(case=name, err=err, grad_err=max(gerr), ms=ms,
                            bwd_ms=bwd_ms, plain_ms=plain_ms,
                            plain_bwd_ms=plain_bwd_ms,
                            library_ms=lib_ms, library_bwd_ms=lib_bwd_ms,
                            bound_ms=bounds[0][0], bound_by=bounds[0][1],
                            bwd_bound_ms=bounds[1][0],
                            bwd_bound_by=bounds[1][1]))
        del q, k, v, dout, out, lse, grads, again
        torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------- phase 3
def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1025, n)
    return [rng.integers(0, vocab, int(ln)).tolist() for ln in lens]


def _drain(model, params, cfg_kw, prompts, new_tokens, device,
           count_copies=False, no_sync=False, sampling=None, on_step=None,
           mm_items=None, enc_items=None, counts=None, max_steps=10_000):
    """Drain ``prompts`` through a new ``Engine``. Returns the engine, the
    wall seconds, and the number of its T == 1 padded dispatches (the
    ones that go through the paged decode kernel); with ``count_copies``
    also the kinds of its state-page copies. With ``no_sync`` every
    dispatch runs under torch's sync debug mode "error", so a host sync
    inside it raises. ``sampling``: extra ``SamplingParams`` fields (the
    seeded draw); ``on_step(eng)`` runs after every engine step;
    ``mm_items`` / ``enc_items``: each prompt's ``MMItem``s (stub image
    or audio frame embeddings); ``counts`` (a dict) gets the number of
    dispatches that run the encoder under "enc"; ``max_steps`` caps the
    engine's steps (the caller checks that every request finished)."""
    import torch
    from repro_torch.serving import Engine, EngineConfig, Request, \
        SamplingParams
    eng = Engine(model, EngineConfig(**cfg_kw), params=params, device=device)
    copies = _count_state_copies(eng) if count_copies else None
    decode = [0]
    dispatch = eng.runner.dispatch

    def counting(params_, prep):
        decode[0] += not prep.info["prefill"]
        if counts is not None:
            counts["enc"] = counts.get("enc", 0) + \
                (prep.arrs["enc_embeds"] is not None)
        if not no_sync:
            return dispatch(params_, prep)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(params_, prep)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng.runner.dispatch = counting
    if on_step is not None:
        step = eng.step

        def stepping():
            out = step()
            on_step(eng)
            return out

        eng.step = stepping
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, sampling=SamplingParams(
            max_new_tokens=new_tokens, **(sampling or {})),
            mm_items=mm_items[i] if mm_items else (),
            encoder_items=enc_items[i] if enc_items else ()))
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_done(max_steps=max_steps)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if count_copies:
        return eng, wall, decode[0], copies
    return eng, wall, decode[0]


def _first_row_diff(ref, other):
    """Max abs difference of the first sampled logits rows (the prompt's
    last token: the same input in every leg, before any fork)."""
    return max(float(np.abs(ref.sample_log[r.rid][0]
                            - other.sample_log[r.rid][0]).max())
               for r in ref.finished)


def _fork_aware_equal(ref, other, label, tol=TIE_FORK_TOL):
    """Greedy outputs of two drained engines (both recording their sampled
    logits rows) agree until a divergence, which must be a near tie in
    both rows (within ``tol``). Returns the number of forks."""
    forked = 0
    outs = {x.rid: list(x.output) for x in other.finished}
    if set(outs) != {r.rid for r in ref.finished}:
        raise AssertionError(f"{label}: different requests finished")
    for r in ref.finished:
        a, b = list(r.output), outs[r.rid]
        i = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                 None)
        if i is None:
            if len(a) != len(b):
                raise AssertionError((label, r.rid, a, b))
            continue
        la, lb = ref.sample_log[r.rid][i], other.sample_log[r.rid][i]
        ga, gb = float(la.max() - la[b[i]]), float(lb.max() - lb[a[i]])
        if ga > tol or gb > tol:
            raise AssertionError(f"{label}: {r.rid} diverges at {i} beyond "
                                 f"the tie tolerance {tol} ({ga}, {gb})")
        forked += 1
    return forked


def _serve_legs(tag, cfg, model, params, base, legs, prompts, new_tokens,
                on_step=None, sampling=None, mm_items=None, on_leg=None,
                enc_items=None, attn_layers=None, copies=None,
                max_steps=10_000, leg_stats=None):
    """Drain ``prompts`` through one ``Engine`` per leg (name, batching
    mode, pipeline depth, config) of full-width ``cfg``: every request
    finishes, no page is left referenced, and each kernel is launched once
    per attention layer of every dispatch that takes it (packed: varlen x
    dispatches, paged never; padded/serial: paged x T == 1 dispatches,
    varlen never; ``attn_layers``: (varlen, paged) calls per such
    dispatch, ``cfg.num_layers`` each by default) and the dense forward
    once per encoder layer of every dispatch that runs the encoder, the
    counts set to 0 before the leg and read after it. Depth-1 legs
    record their logits rows (finite, vocab wide); their finished requests
    and rows are returned by name (legs at other depths that record them,
    as "name depth d"). Each leg's engine, pool and all, is
    released before the next is built (qwen2.5-32b leaves room for one).
    ``on_leg(eng, name, depth)`` runs after each leg's checks, before its
    engine is released; ``mm_items`` and ``enc_items`` go to ``_drain``;
    ``copies`` (a dict) gets each leg's state-page copy kinds by (name,
    depth); ``max_steps`` caps each leg's engine steps (a leg that does
    not drain within it fails); ``leg_stats`` (a dict) gets each leg's wall
    seconds and output tokens by (name, depth). Returns (outputs by (name,
    depth), depth-1 records, launch totals)."""
    import gc
    import types

    import torch
    from repro_torch.kernels.flash_attention import (dense_flash_fwd,
                                                     flash_attention_varlen)
    from repro_torch.kernels.paged_attention import paged_decode_attention

    outs, ref = {}, {}
    launches = {"varlen": 0, "paged": 0, "dense": 0}
    n_varlen, n_paged = attn_layers or (cfg.num_layers, cfg.num_layers)
    for name, mode, depth, kw in legs:
        label = f"{tag} {name} depth={depth}"
        flash_attention_varlen.launches = 0
        paged_decode_attention.launches = 0
        dense_flash_fwd.launches = 0
        counts = {"enc": 0}
        eng, wall, decode, *kinds = _drain(
            model, params, dict(base, batching_mode=mode, **kw), prompts,
            new_tokens, "cuda", sampling=sampling, mm_items=mm_items,
            enc_items=enc_items, counts=counts, max_steps=max_steps,
            count_copies=copies is not None,
            on_step=None if on_step is None else
            (lambda e, n=name, d=depth: on_step(e, n, d)))
        if copies is not None:
            copies[name, depth] = kinds[0]
        varlen = flash_attention_varlen.launches
        paged = paged_decode_attention.launches
        dense = dense_flash_fwd.launches
        launches["varlen"] += varlen
        launches["paged"] += paged
        launches["dense"] += dense
        want_dense = counts["enc"] * cfg.encoder_layers
        if dense != want_dense:
            raise AssertionError(f"{label}: {dense} dense forward launches, "
                                 f"expected {want_dense} ({counts['enc']} "
                                 "encoder dispatches)")
        if len(eng.finished) != len(prompts):
            raise AssertionError(f"{label}: {len(eng.finished)} of "
                                 f"{len(prompts)} requests finished")
        eng.mgr.check_invariants()
        stats = eng.mgr.memory_stats()
        if stats.used_units != 0:
            raise AssertionError(f"{label}: leaked pages: {stats}")
        if mode == "packed":
            want = (eng.runner.dispatch_count * n_varlen, 0)
        else:
            want = (0, decode * n_paged)
            if decode == 0:
                raise AssertionError(f"{label}: no T == 1 dispatch")
        if (varlen, paged) != want:
            raise AssertionError(f"{label}: (varlen, paged) launches "
                                 f"{(varlen, paged)}, expected {want}")
        if kw.get("record_sample_logits"):
            for rid, rws in eng.sample_log.items():
                for r in rws:
                    if r.shape != (cfg.vocab_size,) or \
                            not np.isfinite(r).all():
                        raise AssertionError(f"{label} {rid}: bad logits")
            ref[name if depth == 1 else f"{name} depth {depth}"] = \
                types.SimpleNamespace(finished=eng.finished,
                                      sample_log=eng.sample_log)
        outs[name, depth] = {r.rid: list(r.output) for r in eng.finished}
        n_out = sum(len(o) for o in outs[name, depth].values())
        if leg_stats is not None:
            leg_stats[name, depth] = dict(wall_s=wall, tokens=n_out)
        steps = eng.step_count
        log(f"[{tag}] mode={name} depth={depth} steps={steps} dispatches="
            f"{eng.runner.dispatch_count} decode_dispatches={decode} "
            f"wall_s={wall:.3f} output_tok_per_s={n_out / wall:.1f} "
            f"mean_step_ms={wall / steps * 1e3:.2f} varlen_launches={varlen}"
            f" (expected {want[0]}) paged_launches={paged} (expected "
            f"{want[1]}) dense_fwd_launches={dense} (expected {want_dense}) "
            f"prompt_tokens={sum(len(p) for p in prompts)} "
            f"output_tokens={n_out} leaked_pages=0 card=[{card()}]")
        if on_leg is not None:
            on_leg(eng, name, depth)
        # engines sit in reference cycles through their wrapped methods
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return outs, ref, launches


def _forks_within_noise(tag, ref, names):
    """The depth-1 legs ``names`` fork-aware equal to packed depth 1,
    within twice the noise floor (packed against packed-b256, the same
    path at another token budget). At full width the bf16 sums of many
    layers differ between any two step compositions by far more than
    TIE_FORK_TOL, which was set on reduced configs; a masking or page
    fault moves logits by O(1) (the rows' std is ~0.9), far above it."""
    noise = _first_row_diff(ref["packed"], ref["packed-b256"])
    tol = max(TIE_FORK_TOL, 2 * noise)
    forks = {}
    for name in names:
        diff = _first_row_diff(ref["packed"], ref[name])
        if diff > tol:
            raise AssertionError(f"{tag} {name}: first-token logits differ "
                                 f"from packed by {diff} > {tol}")
        forks[name] = (_fork_aware_equal(ref["packed"], ref[name],
                                         f"{tag} {name}", tol),
                       round(diff, 4))
    return noise, tol, forks


def phase_engine():
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model

    cfg = ARCHS["granite-3-2b"]
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + \
        params["embed"].numel()
    log(f"[engine] granite-3-2b full width: {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    base = dict(kv_pool_bytes=2 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8)
    prompts = _prompts(8, cfg.vocab_size)
    _warm(model, params, base, prompts)

    rec = dict(async_scheduling=False, record_sample_logits=True)
    d2 = dict(async_scheduling=True, pipeline_depth=2)
    d4 = dict(async_scheduling=True, pipeline_depth=4)
    # "packed-b256": the packed path itself at another token budget, the
    # noise floor that the padded and serial legs are held to
    legs = [("packed", "packed", 1, rec), ("packed", "packed", 2, d2),
            ("packed", "packed", 4, d4),
            ("packed-b256", "packed", 1,
             dict(rec, max_num_batched_tokens=256)),
            ("padded", "padded", 1, rec), ("padded", "padded", 2, d2),
            ("padded", "padded", 4, d4), ("serial", "serial", 1, rec)]
    outs, ref, launches = _serve_legs("engine", cfg, model, params, base,
                                      legs, prompts, 32)
    for mode in ("packed", "padded"):
        if not outs[mode, 1] == outs[mode, 2] == outs[mode, 4]:
            raise AssertionError(f"{mode}: outputs differ across depths")
    noise, tol, forks = _forks_within_noise(
        "engine", ref, ("packed-b256", "padded", "serial"))
    log("[engine] outputs bitwise equal across depths 1, 2, 4 (packed; "
        f"padded); noise floor (packed vs packed-b256 first-token logits) "
        f"{noise:.4f}, fork tolerance {tol:.4f}; (forks, first-token diff) "
        f"vs packed: {forks}; 0 leaked pages")
    del ref
    sampled = phase_sampled(cfg, model, params, base, prompts)
    for k in launches:
        launches[k] += sampled[k]
    return launches


def phase_sampled(cfg, model, params, base, prompts):
    """Seeded temperature/top-k serving (temperature 0.8, top-k 50, seed
    42) of full-width granite-3-2b, packed: depth 1 (sync, host-sampled
    through ``host_sample`` on the card), depth 2 (host-sampled), depth 2
    with the fused device tail and depth 4 (device tail). Every leg's
    outputs byte-equal; seed 43 must change them. Also the CUDA kernels
    one ``sample_batch`` call of 8 sampled rows launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.sampler import sample_batch

    seeded = dict(temperature=0.8, top_k=50, seed=42)
    rec = dict(async_scheduling=False, record_sample_logits=True)
    d2 = dict(async_scheduling=True, pipeline_depth=2)
    legs = [("sampled", "packed", 1, rec),
            ("sampled", "packed", 2, d2),
            ("sampled-device", "packed", 2, dict(d2, device_sampling=True)),
            ("sampled", "packed", 4,
             dict(async_scheduling=True, pipeline_depth=4))]
    outs, _, launches = _serve_legs("sampled", cfg, model, params, base,
                                    legs, prompts, 32, sampling=seeded)
    first = outs["sampled", 1]
    if any(o != first for o in outs.values()):
        raise AssertionError(f"sampled legs differ: {outs}")
    other, _, more = _serve_legs("sampled seed 43", cfg, model, params, base,
                                 legs[3:], prompts, 32,
                                 sampling=dict(seeded, seed=43))
    if other["sampled", 4] == first:
        raise AssertionError("seed 43 drew the same outputs as seed 42")
    for k in launches:
        launches[k] += more[k]
    distinct = sum(len(set(o)) for o in first.values())
    # the CUDA kernels of one fused tail over 8 sampled rows
    dev = torch.device("cuda")
    rows = torch.randn((8, cfg.vocab_size), device=dev)
    board = torch.zeros(9, dtype=torch.int32, device=dev)
    dst = torch.arange(8, dtype=torch.int32, device=dev)
    samp = (torch.full((8,), 0.8, device=dev),
            torch.full((8,), 50, dtype=torch.int32, device=dev),
            torch.arange(8, dtype=torch.int32, device=dev),
            torch.arange(8, dtype=torch.int32, device=dev) + 100,
            torch.full((8,), 42, dtype=torch.int32, device=dev))
    sample_batch(rows, board, dst, samp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sample_batch(rows, board, dst, samp)
        torch.cuda.synchronize()
    n_k = sum(e.count for e in prof.key_averages()
              if _dev_us(e) > 0)
    tail_ms = cuda_time_ms(lambda: sample_batch(rows, board, dst, samp))
    greedy_ms = cuda_time_ms(lambda: sample_batch(rows, board, dst))
    log(f"[sampled] temperature 0.8 top-k 50 seed 42: outputs byte-equal "
        f"across packed depth 1 (sync, host_sample on the card), depth 2 "
        f"(host), depth 2 (device tail) and depth 4 (device tail); seed 43 "
        f"differs; {distinct} distinct tokens over {len(first)} "
        f"requests; one fused tail over 8 sampled rows of "
        f"{cfg.vocab_size}: {n_k} CUDA kernel launches, {tail_ms:.4f} ms "
        f"per call (greedy tail {greedy_ms:.4f} ms)")
    return launches


# ----------------------------------------------------------------- phase 4
def phase_small_reference(arch):
    """Reduced ``arch`` served on the card (kernels) and on the CPU (plain
    versions) with the same weights: the card's packed, padded and serial
    engines against the CPU's packed engine, up to genuine near-ties
    (TIE_FORK_TOL); whisper with 3 of its 4 prompts carrying a clip.
    Phase 4 (granite-3-2b), 4b (zamba2-1.2b) and the end of phase 8."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model
    from repro_torch.serving import MMItem

    cfg = reduced(ARCHS[arch])
    model = build_model(cfg)
    cpu_params = model.init(seed=0, device="cpu")

    def cuda(tree):
        return {k: (cuda(v) if isinstance(v, dict) else v.cuda())
                for k, v in tree.items()}

    gpu_params = cuda(cpu_params)
    kw = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8,
              max_num_batched_tokens=64, record_sample_logits=True)
    prompts = _prompts(4, cfg.vocab_size, seed=1)
    prompts = [p[:8 + 5 * i] for i, p in enumerate(prompts)]
    enc = None
    if cfg.family == "encdec":
        enc = [(MMItem(0, cfg.encoder_seq, mm_hash=i),) if i != 1 else ()
               for i in range(4)]
    ref, _, _ = _drain(model, cpu_params, kw, prompts, 8, "cpu",
                       enc_items=enc)
    for mode in ("packed", "padded", "serial"):
        eng, _, decode = _drain(model, gpu_params,
                                dict(kw, batching_mode=mode), prompts, 8,
                                "cuda", enc_items=enc)
        n = _fork_aware_equal(ref, eng, f"{arch} {mode} card vs packed CPU")
        log(f"[reference] reduced {arch} {mode} on the card vs packed on "
            f"the CPU: {decode} T == 1 dispatches, {n} forked at near-ties "
            f"(TIE_FORK_TOL {TIE_FORK_TOL}), first-token logits max abs "
            f"diff {_first_row_diff(ref, eng):.3e}")


# ---------------------------------------------------------------- phase 3b
def hybrid_serving_setup():
    """zamba2-1.2b at its published widths and depth, with
    ``tokens_per_page`` 19 (the default 16 makes the LCM page 29.9 GiB,
    and serving needs three of them), and the engine settings of the
    smoke's hybrid legs: a pool of 4 large pages, the granite legs'
    budget, chunk and batch."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.core.spec import BYTES_PER_UNIT, lcm
    from repro_torch.models import build_model

    cfg = dataclasses.replace(ARCHS["zamba2-1.2b"], tokens_per_page=19)
    model = build_model(cfg)
    big = lcm([sp.page_units for sp in model.kv_specs()])
    base = dict(kv_pool_bytes=4 * big * BYTES_PER_UNIT,
                max_num_batched_tokens=512, chunk_size=256, max_running=8)
    return cfg, model, base


def _count_state_copies(eng):
    """Wrap the runner's ``apply_copies``; returns the list it fills with
    the kind of every state-page copy (checkpoint / restore)."""
    kinds = []
    apply = eng.runner.apply_copies

    def counting(ops):
        kinds.extend(op.kind for op in ops
                     if op.type_name in ("mamba", "rwkv"))
        return apply(ops)

    eng.runner.apply_copies = counting
    return kinds


def phase_hybrid_engine():
    """Full-width zamba2-1.2b (random bf16 weights from seed 0) served by
    ``Engine`` with the 8 prompts of phase 3: packed at depths 1, 2 and 4
    (outputs bitwise equal, mamba launches == dispatches x 38, varlen ==
    dispatches x 6; the depth-4 dispatches under sync debug mode "error"),
    packed at a 256-token budget as the noise floor, and
    padded and serial at depth 1 (fork-aware equal to packed within twice
    that floor; mamba launches == T > 1 dispatches x 38, paged == T == 1
    dispatches x 6). Every leg drains with no leaked page."""
    import gc
    import types

    import torch
    from repro_torch.kernels.flash_attention import flash_attention_varlen
    from repro_torch.kernels.mamba_scan import mamba_chunk_scan_varlen
    from repro_torch.kernels.paged_attention import paged_decode_attention

    # each leg's pool is 9.3 GiB: let the earlier phases' engines (held in
    # reference cycles through their wrapped dispatch) go first
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, base = hybrid_serving_setup()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for v in params.values()
                   for w in (v.values() if isinstance(v, dict) else [v]))
    n_super = cfg.num_layers // cfg.attn_every
    log(f"[hybrid] zamba2-1.2b full width: {cfg.num_layers} Mamba2 layers, "
        f"shared attention x {n_super}, {n_params / 1e9:.3f} B params, "
        f"tokens_per_page {cfg.tokens_per_page}, pool "
        f"{base['kv_pool_bytes'] / 2 ** 30:.2f} GiB (4 large pages), init "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = _prompts(8, cfg.vocab_size)
    for mode in ("packed", "padded"):
        _drain(model, params, dict(base, batching_mode=mode),
               [prompts[0][:64], prompts[1][:64]], 2, "cuda")
        gc.collect()
        torch.cuda.empty_cache()

    rec = dict(async_scheduling=False, record_sample_logits=True)
    legs = [("packed", "packed", 1, rec),
            ("packed", "packed", 2,
             dict(async_scheduling=True, pipeline_depth=2)),
            ("packed", "packed", 4,
             dict(async_scheduling=True, pipeline_depth=4)),
            ("packed-b256", "packed", 1,
             dict(rec, max_num_batched_tokens=256)),
            ("padded", "padded", 1, rec), ("serial", "serial", 1, rec)]
    # the depth-4 leg issues every dispatch under torch's sync debug mode
    # "error": a host sync inside the hybrid step would serialise the ring
    kernels = (mamba_chunk_scan_varlen, flash_attention_varlen,
               paged_decode_attention)
    launches = dict(mamba=0, varlen=0, paged=0)
    outs, ref, rows = {}, {}, []
    memory = {}
    for name, mode, depth, kw in legs:
        label = f"hybrid {name} depth={depth}"
        for fn in kernels:
            fn.launches = 0
        with _allocation_peaks() as peaks:
            # the packed depth-1 leg is also leg (c)'s "lcm" side
            # (``phase_max_geometry``): the same pool, prompts and budget
            eng, wall, decode, copies = _drain(
                model, params, dict(base, batching_mode=mode, **kw),
                prompts, 32, "cuda", count_copies=True, no_sync=depth == 4,
                on_step=_memory_watch(memory, peaks) if
                (name, depth) == ("packed", 1) else None)
        got = dict(zip(launches, (fn.launches for fn in kernels)))
        for k in launches:
            launches[k] += got[k]
        if len(eng.finished) != len(prompts):
            raise AssertionError(f"{label}: {len(eng.finished)} of "
                                 f"{len(prompts)} requests finished")
        eng.mgr.check_invariants()
        stats = eng.mgr.memory_stats()
        if stats.used_units != 0:
            raise AssertionError(f"{label}: leaked pages: {stats}")
        full = eng.runner.dispatch_count - decode
        want = dict(mamba=full * cfg.num_layers,
                    varlen=full * n_super if mode == "packed" else 0,
                    paged=0 if mode == "packed" else decode * n_super)
        if got != want or (mode != "packed" and decode == 0):
            raise AssertionError(f"{label}: launches {got}, expected {want} "
                                 f"({decode} T == 1 dispatches)")
        if not copies.count("checkpoint"):
            raise AssertionError(f"{label}: no state checkpoint copy")
        if depth == 1:
            for rid, rws in eng.sample_log.items():
                for r in rws:
                    if r.shape != (cfg.vocab_size,) or \
                            not np.isfinite(r).all():
                        raise AssertionError(f"{label} {rid}: bad logits")
            # what the fork checks read; the engine and its pool go
            ref[name] = types.SimpleNamespace(sample_log=eng.sample_log,
                                              finished=eng.finished)
        outs[name, depth] = {r.rid: list(r.output) for r in eng.finished}
        n_out = sum(len(o) for o in outs[name, depth].values())
        steps = eng.step_count
        log(f"[hybrid] mode={name} depth={depth} steps={steps} dispatches="
            f"{eng.runner.dispatch_count} decode_dispatches={decode} "
            f"wall_s={wall:.3f} output_tok_per_s={n_out / wall:.1f} "
            f"mean_step_ms={wall / steps * 1e3:.2f} mamba_launches="
            f"{got['mamba']} varlen_launches={got['varlen']} paged_launches="
            f"{got['paged']} state_checkpoints={copies.count('checkpoint')}"
            f" (caught up after deferral: {eng.mgr.catchup_checkpoints}) "
            f"output_tokens={n_out}")
        rows.append(dict(mode=name, depth=depth, steps=steps, wall_s=wall))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if not outs["packed", 1] == outs["packed", 2] == outs["packed", 4]:
        raise AssertionError("hybrid packed: outputs differ across depths")
    noise = _first_row_diff(ref["packed"], ref["packed-b256"])
    tol = max(TIE_FORK_TOL, 2 * noise)
    forks = {}
    for name in ("packed-b256", "padded", "serial"):
        diff = _first_row_diff(ref["packed"], ref[name])
        if diff > tol:
            raise AssertionError(f"hybrid {name}: first-token logits differ "
                                 f"from packed by {diff} > {tol}")
        forks[name] = (_fork_aware_equal(ref["packed"], ref[name], name,
                                         tol), round(diff, 4))
    log("[hybrid] packed outputs bitwise equal across depths 1, 2, 4; noise "
        f"floor (packed vs packed-b256 first-token logits) {noise:.4f}, fork "
        f"tolerance {tol:.4f}; (forks, first-token diff) vs packed: {forks};"
        " 0 leaked pages")
    del params
    torch.cuda.empty_cache()
    # what phase_max_geometry compares with
    HYBRID_3B.update(tol=tol, memory=memory, outputs=outs["packed", 1])
    return launches, rows


HYBRID_3B = {}      # phase 3b's fork tolerance, leg memory and outputs


def _memory_watch(out, peaks):
    """An ``on_step`` that keeps a drained engine's memory numbers in
    ``out``: the most used units (``_allocation_peaks``), the most
    requests running at once, defers, preemptions, and at the peak the
    units its live pages lose to padding (a page's stride beyond its own
    units: the MAX geometry's pad) and the units reserved but empty inside
    owned large pages (the LCM geometry's internal fragmentation)."""
    out.update(peak=0, running=0, pad=0, empty=0)

    def watch(eng):
        sched, mgr = eng.scheduler, eng.mgr
        layout = eng.runner.layout
        st = mgr.memory_stats()
        if peaks.get(mgr, 0) >= out["peak"]:
            out["pad"] = max(out["pad"], sum(
                t.used * (layout.stride(n) - t.page_units)
                for n, t in st.per_type.items()))
            out["empty"] = max(out["empty"], st.empty_units)
        out["peak"] = max(out["peak"], peaks.get(mgr, 0))
        out["running"] = max(out["running"], len(sched.running))
        out["defers"], out["preempts"] = (sched.defer_count,
                                          sched.preemption_count)
    return watch


MAX_POOL_LCM_PAGES = 16     # leg (a)/(b)'s pool, in tokens_per_page-19 LCM pages


@contextlib.contextmanager
def _pagesan():
    """PageSan on for the managers built inside the block."""
    import os
    was = os.environ.get("REPRO_PAGE_SANITIZER")
    os.environ["REPRO_PAGE_SANITIZER"] = "1"
    try:
        yield
    finally:
        if was is None:
            os.environ.pop("REPRO_PAGE_SANITIZER")
        else:
            os.environ["REPRO_PAGE_SANITIZER"] = was


def phase_max_geometry(device="cuda"):
    """zamba2-1.2b at full width under ``geometry_mode="max"`` (the paper's
    §4.4 baseline: every small page padded to the 41.8 MB Mamba state
    page), random bf16 weights from seed 0 and phase 3's 8 prompts, PageSan
    on.

    (a) At tokens_per_page 19, packed at depths 1 and 4 and padded, in
    both geometries at a pool that holds the whole set in each
    (MAX_POOL_LCM_PAGES LCM pages, 32.08 GB: request-aware allocation
    gives each running request a large page of each type under "lcm"; no
    defer, no preemption): greedy outputs bitwise equal ("max" only moves
    addresses; the kernels' plans read page ids as places, never as
    values). (b) At the published tokens_per_page 16, which "lcm" cannot
    hold on one card (three 29.9 GiB LCM pages), packed and padded under
    "max" at the same pool, fork-aware equal to (a)'s "lcm" legs within
    twice phase 3b's noise floor (``HYBRID_3B["tol"]``: the page size
    moves reduction boundaries). (c) Memory at phase 3b's pool (4 LCM
    pages, 8.02 GB = 192 MAX pages): packed at depth 1 under "max" beside
    phase 3b's packed depth-1 leg (``HYBRID_3B["memory"]``): the most used
    units, requests running at once, defers, preemptions, and the units
    lost to padding. Every leg drains with no leaked page and launches
    mamba x 38 per T > 1 dispatch, varlen x 6 per packed one and paged x 6
    per T == 1 one; each geometry's legs are held to the planner. Returns
    the launch totals."""
    with _pagesan():
        return _max_geometry_legs(HYBRID_3B, device)


def _max_geometry_legs(hybrid, device):
    """``phase_max_geometry``'s legs, PageSan on."""
    import dataclasses
    import gc

    import torch
    from repro_torch.core.spec import BYTES_PER_UNIT
    from repro_torch.kernels.mamba_scan import mamba_chunk_scan_varlen
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, base = hybrid_serving_setup()
    params = model.init(seed=0, device=device)
    n_super = cfg.num_layers // cfg.attn_every
    lcm_page = base["kv_pool_bytes"] // 4
    pool = dict(base, kv_pool_bytes=MAX_POOL_LCM_PAGES * lcm_page)
    prompts = _prompts(8, cfg.vocab_size)
    tol = hybrid["tol"]
    launches = dict(mamba=0, varlen=0, paged=0)
    memory = {}

    def run(tag, legs, m, base_):
        """``_serve_legs`` of ``m`` (mamba launches checked per leg), all
        of one geometry, then the planner against the legs' peak."""
        geometry = {kw["geometry_mode"] for *_, kw in legs}.pop()
        torch.cuda.reset_peak_memory_stats()
        mamba_chunk_scan_varlen.launches = 0
        marks = []

        def on_leg(eng, name, depth):
            t1 = paged_decode_attention.launches // n_super
            full = eng.runner.dispatch_count - t1
            got = mamba_chunk_scan_varlen.launches - sum(marks)
            marks.append(got)
            if got != full * cfg.num_layers:
                raise AssertionError(f"{tag} {name} depth={depth}: {got} "
                                     f"mamba launches, expected "
                                     f"{full * cfg.num_layers}")
            if not eng.mgr.sanitizer:
                raise AssertionError(f"{tag}: PageSan is off")
            g = eng.mgr.geometry
            log(f"[{tag}] {name} depth={depth}: geometry {g.mode}, "
                f"{g.num_large_pages} large pages of "
                f"{g.large_page_units * BYTES_PER_UNIT / 1e6:.3f} MB, page "
                f"strides {eng.runner.page_strides}, buffer "
                f"{eng.runner.buffer.numel() * 2 / 1e9:.3f} GB")

        watch, fns = {}, {}
        with _allocation_peaks() as peaks:

            def on_step(eng, name, depth):
                if (name, depth) not in fns:
                    fns[name, depth] = _memory_watch(
                        watch.setdefault((name, depth), {}), peaks)
                fns[name, depth](eng)

            outs, ref, more = _serve_legs(
                tag, m.cfg, m, params, base_, legs, prompts, 32,
                on_step=on_step, on_leg=on_leg,
                attn_layers=(n_super, n_super))
        for k in ("varlen", "paged"):
            launches[k] += more[k]
        launches["mamba"] += sum(marks)
        for key, st in watch.items():
            memory[(tag,) + key] = st
        _serve_fit(m, dict(base_, geometry_mode=geometry), prompts, 32,
                   label=f" tpp {m.cfg.tokens_per_page} {geometry} "
                   f"{base_['kv_pool_bytes'] / 1e9:.2f} GB")
        return outs, ref

    rec = dict(async_scheduling=False, record_sample_logits=True)
    deep = dict(async_scheduling=True, pipeline_depth=4)
    t0 = time.perf_counter()
    outs_a, ref_a = {}, {}
    for g in ("lcm", "max"):
        legs_a = [(f"{g}-{n}", mode, d, dict(kw, geometry_mode=g))
                  for n, mode, d, kw in (("packed", "packed", 1, rec),
                                         ("packed", "packed", 4, deep),
                                         ("padded", "padded", 1, rec))]
        outs, ref = run("max-geometry (a) tpp 19", legs_a, model, pool)
        outs_a.update(outs)
        ref_a.update(ref)
    for n, d in (("packed", 1), ("packed", 4), ("padded", 1)):
        if outs_a[f"lcm-{n}", d] != outs_a[f"max-{n}", d]:
            diff = _first_row_diff(ref_a[f"lcm-{n}"], ref_a[f"max-{n}"]) \
                if d == 1 else None
            raise AssertionError(f"max-geometry (a) {n} depth={d}: "
                                 f"outputs differ from lcm (first-token "
                                 f"diff {diff})")
    for key, st in memory.items():
        if st["defers"] or st["preempts"]:
            raise AssertionError(f"max-geometry (a) {key}: the pool did "
                                 f"not hold the whole set: {st}")
    log(f"[max-geometry (a)] tokens_per_page 19, pool "
        f"{pool['kv_pool_bytes'] / 1e9:.3f} GB: max == lcm bitwise in packed"
        f" depths 1 and 4 and padded, no defer or preemption; lcm packed == "
        f"phase 3b's packed depth 1 at its 8.02 GB pool: "
        f"{outs_a['lcm-packed', 1] == hybrid['outputs']}; "
        f"{time.perf_counter() - t0:.1f} s; card=[{card()}]")

    t0 = time.perf_counter()
    cfg16 = dataclasses.replace(cfg, tokens_per_page=16)
    model16 = build_model(cfg16)
    sizes = {s.name: s.page_units for s in model16.kv_specs()}
    lcm16 = np.lcm.reduce(list(sizes.values())) * BYTES_PER_UNIT
    legs_b = [("max-packed", "packed", 1, dict(rec, geometry_mode="max")),
              ("max-padded", "padded", 1, dict(rec, geometry_mode="max"))]
    outs_b, ref_b = run("max-geometry (b) tpp 16", legs_b, model16, pool)
    forks = {}
    for n in ("packed", "padded"):
        diff = _first_row_diff(ref_a[f"lcm-{n}"], ref_b[f"max-{n}"])
        if diff > tol:
            raise AssertionError(f"max-geometry (b) {n}: first-token "
                                 f"logits differ from (a)'s lcm by {diff} "
                                 f"> {tol}")
        forks[n] = (_fork_aware_equal(ref_a[f"lcm-{n}"], ref_b[f"max-{n}"],
                                      f"max-geometry (b) {n}", tol),
                    round(diff, 4))
    log(f"[max-geometry (b)] tokens_per_page 16 (pages {sizes} units; the "
        f"LCM page would be {lcm16 / 2 ** 30:.2f} GiB and a pool of two plus "
        f"the scratch page {3 * lcm16 / 2 ** 30:.2f} GiB): served under max "
        f"at {pool['kv_pool_bytes'] / 1e9:.3f} GB; (forks, first-token diff)"
        f" vs (a)'s lcm at tokens_per_page 19 within {tol:.4f}: {forks}; "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    legs_c = [("max-packed", "packed", 1, dict(rec, geometry_mode="max"))]
    outs_c, ref_c = run("max-geometry (c) pool 8.02 GB", legs_c, model, base)
    mem = {"lcm (phase 3b packed depth 1)": hybrid["memory"],
           "max": memory["max-geometry (c) pool 8.02 GB", "max-packed", 1]}
    for name, st in mem.items():
        log(f"[max-geometry (c)] {name} at {base['kv_pool_bytes'] / 1e9:.3f}"
            f" GB: peak_used_units={st['peak']} max_running={st['running']} "
            f"defers={st['defers']} preemptions={st['preempts']} "
            f"pad_units_at_peak={st['pad']} empty_units_at_peak="
            f"{st['empty']}")
    log(f"[max-geometry (c)] max outputs == phase 3b's lcm packed: "
        f"{outs_c['max-packed', 1] == hybrid['outputs']}; "
        f"{time.perf_counter() - t0:.1f} s; card=[{card()}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- phase 6
def _leaves(tree):
    """The tensors of a (nested) parameter dict."""
    return [w for v in tree.values()
            for w in (_leaves(v) if isinstance(v, dict) else [v])]


def _full_width(arch, **overrides):
    """Full-width ``arch`` (its config with ``overrides``: a depth cut)
    with random bf16 weights drawn on the card from seed 0, after the
    earlier phases' engines, weights and pools are gone; the card's free
    memory is printed before and after, and its peak-memory count reset."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free0, total = torch.cuda.mem_get_info()
    cfg = dataclasses.replace(ARCHS[arch], **overrides)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    leaves = _leaves(params)
    n_params = sum(w.numel() for w in leaves)
    n_bytes = sum(w.numel() * w.element_size() for w in leaves)
    free1, _ = torch.cuda.mem_get_info()
    moe = (f", {cfg.num_experts} experts top-{cfg.experts_per_token} of ff "
           f"{cfg.moe_d_ff}" if cfg.num_experts else "")
    cut = (f" (of {ARCHS[arch].num_layers})" if "num_layers" in overrides
           else "")
    log(f"[{arch}] full width: {cfg.num_layers} layers{cut}, d "
        f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, ff {cfg.d_ff}{moe}, vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f} B "
        f"params, {n_bytes / 1e9:.2f} GB, init "
        f"{time.perf_counter() - t0:.1f} s; card memory free "
        f"{free0 / 2 ** 30:.2f} GiB before, {free1 / 2 ** 30:.2f} GiB after "
        f"(of {total / 2 ** 30:.2f})")
    return cfg, model, params


def _warm(model, params, base, prompts):
    """Warm-up (cuBLAS handles, allocator) before anything is counted."""
    import gc

    import torch
    for mode in ("packed", "padded"):
        _drain(model, params, dict(base, batching_mode=mode),
               [prompts[0][:64], prompts[1][:64]], 2, "cuda")
        gc.collect()
        torch.cuda.empty_cache()


def _leg_set(depths=(1,), padded=True, serial=False):
    rec = dict(async_scheduling=False, record_sample_logits=True)
    legs = [("packed", "packed", 1, rec)]
    legs += [("packed", "packed", d,
              dict(async_scheduling=True, pipeline_depth=d))
             for d in depths if d != 1]
    legs.append(("packed-b256", "packed", 1,
                 dict(rec, max_num_batched_tokens=256)))
    if padded:
        legs.append(("padded", "padded", 1, rec))
    if serial:
        legs.append(("serial", "serial", 1, rec))
    return legs


def phase_danube():
    """h2o-danube-3-4b at full width, 6 of its 24 layers (head dim 120
    through the D 128 kernel instances; window 4096 on every second
    layer; the planner holds the cut to its fitting depth): the 6 first
    prompts of phase 3 and 2 prompts of 5,000-6,000 tokens, 32 new tokens
    each, packed at depths 1 and 4, packed-b256, padded and serial. At the
    end of the longest prompt's prefill its SWA type holds at most its
    window's pages, ceil(4096 / TPP) + 1, while the full type holds the
    whole prompt."""
    import math

    from repro_torch.core.request import SequenceState

    cfg, model, params = _full_width("h2o-danube-3-4b", num_layers=6)
    base = dict(kv_pool_bytes=4 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8)
    rng = np.random.default_rng(0)
    long = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(5000, 6001, 2)]
    prompts = _prompts(8, cfg.vocab_size)[:6] + long
    _warm(model, params, base, prompts)
    tpp, window = cfg.tokens_per_page, cfg.sliding_window
    rid = f"r{int(np.argmax([len(p) for p in prompts]))}"
    held = {}

    def on_step(eng, name, depth):
        if (name, depth) in held:
            return
        for r in eng.scheduler.running:
            if r.rid == rid and r.seq.num_computed >= len(r.prompt):
                held[name, depth] = len(r.prompt), {
                    t: sum(e != SequenceState.FREED for e in tab)
                    for t, tab in r.seq.page_tables.items()}

    legs = _leg_set(depths=(1, 4), serial=True)
    outs, ref, launches = _serve_legs("danube", cfg, model, params, base,
                                      legs, prompts, 32, on_step=on_step)
    if outs["packed", 1] != outs["packed", 4]:
        raise AssertionError("danube packed: outputs differ across depths")
    noise, tol, forks = _forks_within_noise("danube", ref,
                                            ("padded", "serial"))
    swa_max = math.ceil(window / tpp) + 1
    for (name, depth), (n_long, h) in sorted(held.items()):
        full_min = math.ceil(n_long / tpp)
        log(f"[danube] {name} depth={depth}: at the end of {rid}'s "
            f"{n_long}-token prefill its pages per KV type: {h} (swa at "
            f"most {swa_max}, full at least {full_min}; TPP {tpp})")
        if depth == 1 and not (h["swa"] <= swa_max and
                               h["full_attn"] >= full_min):
            raise AssertionError(f"danube {name}: pages held {h}")
    if ("packed", 1) not in held:
        raise AssertionError("danube: the longest prefill was not seen")
    log(f"[danube] outputs bitwise equal across packed depths 1, 4; noise "
        f"floor {noise:.4f}, fork tolerance {tol:.4f}; (forks, first-token "
        f"diff) vs packed: {forks}; 0 leaked pages")
    more = _baseline_legs("danube", cfg, model, params, base, prompts, 32,
                          tol)
    for k in launches:
        launches[k] += more[k]
    _serve_fit(model, base, prompts, 32)
    return launches


def phase_internlm2():
    """internlm2-1.8b at full width (head dim 128): phase 3's 8 prompts,
    packed at depth 1, packed-b256 and padded."""
    cfg, model, params = _full_width("internlm2-1.8b")
    base = dict(kv_pool_bytes=2 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8)
    prompts = _prompts(8, cfg.vocab_size)
    _warm(model, params, base, prompts)
    _, ref, launches = _serve_legs("internlm2", cfg, model, params, base,
                                   _leg_set(), prompts, 32)
    noise, tol, forks = _forks_within_noise("internlm2", ref, ("padded",))
    log(f"[internlm2] noise floor {noise:.4f}, fork tolerance {tol:.4f}; "
        f"(forks, first-token diff) vs packed: {forks}; 0 leaked pages")
    _serve_fit(model, base, prompts, 32)
    return launches


def phase_qwen():
    """qwen2.5-32b at full width (64 layers, QKV bias, vocab 152064;
    65.5 GB of bf16 weights) on the one card: its pool is what the card
    has free after the weights, less 4 GiB for the step's activations.
    Phase 3's 8 prompts, 16 new tokens, packed at depth 1, packed-b256
    and padded at depth 1."""
    import torch

    cfg, model, params = _full_width("qwen2.5-32b")
    free, _ = torch.cuda.mem_get_info()
    pool = free - (4 << 30)
    prompts = _prompts(8, cfg.vocab_size)
    per_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    need = sum(len(p) + 16 + cfg.tokens_per_page for p in prompts) * \
        per_token
    log(f"[qwen2.5-32b] pool {pool / 2 ** 30:.2f} GiB of the "
        f"{free / 2 ** 30:.2f} GiB free after the weights; the 8 prompts "
        f"need {need / 2 ** 30:.2f} GiB of K/V")
    if pool < need:
        raise AssertionError(f"qwen2.5-32b does not fit at full depth: "
                             f"pool {pool} < {need} bytes")
    base = dict(kv_pool_bytes=pool, max_num_batched_tokens=512,
                chunk_size=256, max_running=8)
    _warm(model, params, base, prompts)
    _, ref, launches = _serve_legs("qwen2.5-32b", cfg, model, params, base,
                                   _leg_set(), prompts, 16)
    noise, tol, forks = _forks_within_noise("qwen2.5-32b", ref,
                                            ("padded",))
    log(f"[qwen2.5-32b] noise floor {noise:.4f}, fork tolerance {tol:.4f}; "
        f"(forks, first-token diff) vs packed: {forks}; 0 leaked pages; "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB")
    _serve_fit(model, base, prompts, 16)
    return launches


# ----------------------------------------------------------------- phase 7
# (arch, layers kept): neither MoE fits one 80 GB card whole; each keeps
# its full per-layer width (qwen3-moe: 4.83 GB of experts a layer, dbrx:
# 6.34 GB) and its embeddings, at ~52 and ~55 GB of bf16 weights
MOE_CUTS = (("qwen3-moe-235b-a22b", 5), ("dbrx-132b", 4))


def _moe_numerics():
    """The MoE block's card-side numerics before any model is served: the
    expert products' fp32 route (``torch.bmm(..., out_dtype=float32)`` of
    bf16 operands, at qwen3-moe's prefill shape) against the fp32 product
    of the same values (exact products, fp32 sums: equal up to the order of
    summation), and ``moe_block`` of reduced qwen3-moe widths (16 experts,
    top-8, 96 tokens, capacity binding at factor 0.5) on the card against
    the CPU: the same dropped copies and outputs within TOL relative to
    the largest (outputs reach ~8 here; the expert products' sums in
    cuBLAS's order round h and y, each to bf16, other ways now and
    then)."""
    import torch
    from repro_torch.models import blocks_attn as BA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    a = torch.randn((128, 40, 4096), generator=gen, device=dev).to(
        torch.bfloat16)
    b = (0.02 * torch.randn((128, 4096, 1536), generator=gen,
                            device=dev)).to(torch.bfloat16)
    got = BA._bmm_f32(a, b)
    want = torch.bmm(a.float(), b.float())
    torch.cuda.synchronize()
    if got.dtype != torch.float32:
        raise AssertionError(f"expert product dtype {got.dtype}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not rel < 1e-5:
        raise AssertionError(f"bf16 bmm with fp32 output off by {rel} "
                             "(relative) from the fp32 product")
    f32_ms = cuda_time_ms(lambda: BA._bmm_f32(a, b))
    up_ms = cuda_time_ms(lambda: torch.bmm(a.float(), b.float()), iters=5)
    del a, b, got, want
    rng = np.random.default_rng(8)
    d, e, k, ff = 256, 16, 8, 128
    layer = {"mlp_norm": torch.ones(d),
             "router": torch.tensor(0.1 * rng.standard_normal((d, e)),
                                    dtype=torch.float32)}
    for name, shape in (("moe_gate", (e, d, ff)), ("moe_up", (e, d, ff)),
                        ("moe_down", (e, ff, d))):
        layer[name] = torch.tensor(0.1 * rng.standard_normal(shape),
                                   dtype=torch.bfloat16)
    x = torch.tensor(rng.standard_normal((1, 96, d)), dtype=torch.bfloat16)
    outs, slots = [], []
    for where in ("cpu", "cuda"):
        p = {n: w.to(where) for n, w in layer.items()}
        tok = x.to(where)[0]
        _, _, slot, cap = BA.moe_route(tok, p["router"], num_experts=e,
                                       top_k=k, capacity_factor=0.5)
        slots.append(slot.cpu())
        outs.append(BA.moe_block(p, x.to(where), num_experts=e, top_k=k,
                                 capacity_factor=0.5).float().cpu())
    dropped = int((slots[0] == e * cap).sum())
    if not torch.equal(slots[0], slots[1]):
        raise AssertionError("moe_route: the card drops other copies than "
                             "the CPU")
    ulp = torch.exp2(torch.floor(torch.log2(
        outs[0].abs().clamp_min(1e-30))) - 7)
    diff = (outs[1] - outs[0]).abs()
    err, ulps = diff.max().item(), (diff / ulp).max().item()
    tol = TOL * max(1.0, outs[0].abs().max().item())
    if not err <= tol:
        raise AssertionError(f"moe_block: card and CPU differ by {err} > "
                             f"{tol}")
    log(f"[moe] expert product (128, 40, 4096) x (128, 4096, 1536) bf16 "
        f"with fp32 output: {f32_ms:.4f} ms, rel err {rel:.2e} against "
        f"the fp32 product of the same values ({up_ms:.4f} ms); reduced "
        f"moe_block (E 16, top-8, 96 tokens, cap {cap}): {dropped} of "
        f"{96 * k} copies dropped, the same on the card and the CPU, "
        f"outputs within {err:.3e} ({ulps:.1f} bf16 ulps; tol {tol:.3e}); "
        f"card=[{card()}]")


def _moe_model(arch, layers):
    """One MoE at full per-layer width and ``layers`` layers: phase 3's 8
    prompts, budget 512, chunk 256, a 4 GiB pool, 32 new tokens; packed at
    depths 1 and 4 (fork-aware equal, forks printed: the reference's own
    depths may differ where requests end early, which here they do not),
    packed-b256, padded and serial (fork-aware within twice the noise
    floor), and a seeded packed leg (temperature 0.8, top-k 50); the
    dropped (token, k) copies of every dispatch (qwen3-moe must drop:
    its decode capacity is round(8 * 8 / 128 * 1.25) = 1)."""
    import torch

    cfg, model, params = _full_width(arch, num_layers=layers)
    tag = arch.split("-")[0]
    base = dict(kv_pool_bytes=4 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8)
    prompts = _prompts(8, cfg.vocab_size)
    _warm(model, params, base, prompts)
    drops = {}

    def on_leg(eng, name, depth):
        drops[name, depth] = [int(n) for n in
                              torch.stack(model.moe_drops).cpu()]
        model.moe_drops = []

    rec = dict(async_scheduling=False, record_sample_logits=True)
    legs = [("packed", "packed", 1, rec),
            ("packed", "packed", 4, dict(rec, async_scheduling=True,
                                         pipeline_depth=4)),
            ("packed-b256", "packed", 1,
             dict(rec, max_num_batched_tokens=256)),
            ("padded", "padded", 1, rec), ("serial", "serial", 1, rec)]
    model.moe_drops = []
    try:
        outs, ref, launches = _serve_legs(tag, cfg, model, params, base,
                                          legs, prompts, 32, on_leg=on_leg)
        seeded, _, more = _serve_legs(
            f"{tag} seeded", cfg, model, params, base,
            [("seeded", "packed", 1, dict(async_scheduling=False))],
            prompts, 32, sampling=dict(temperature=0.8, top_k=50, seed=42),
            on_leg=on_leg)
    finally:
        model.moe_drops = None
    for k in launches:
        launches[k] += more[k]
    if seeded["seeded", 1] == outs["packed", 1]:
        raise AssertionError(f"{tag}: the seeded draw equals greedy")
    bitwise = outs["packed", 1] == outs["packed", 4]
    noise, tol, forks = _forks_within_noise(tag, ref, ("padded", "serial"))
    depth_forks = _fork_aware_equal(ref["packed"], ref["packed depth 4"],
                                    f"{tag} packed depth 4", tol)
    for (name, depth), per in drops.items():
        log(f"[{tag}] dropped (token, k) copies per dispatch, {name} depth "
            f"{depth}: total {sum(per)} over {len(per)} dispatches, "
            f"{sum(n > 0 for n in per)} dispatches with drops; {per}")
    if cfg.num_experts == 128 and sum(drops["packed", 1]) == 0:
        raise AssertionError(f"{tag}: no copy dropped at decode capacity 1")
    log(f"[{tag}] packed depth 4 vs depth 1: bitwise equal {bitwise}, "
        f"forks {depth_forks} (fork-aware within {tol:.4f}); noise floor "
        f"{noise:.4f}; (forks, first-token diff) vs packed: {forks}; 0 "
        f"leaked pages; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"card=[{card()}]")
    _serve_fit(model, base, prompts, 32)
    return launches


def _vlm():
    """qwen2-vl-2b at full width (28 layers, d 1536, 12 / 2 heads of 128,
    QKV bias, M-RoPE): phase 3's 8 prompts, 4 of them carrying one image
    each of 64-256 stub-embedded positions (r0 and r2 the same image),
    packed at depths 1 and 4 (bitwise equal), packed-b256 and padded
    (fork-aware); every leg runs the frontend once per distinct image
    (``encoder_runs`` == 3); a packed leg of the same prompts without
    images moves the image rows' first-token logits by more than it moves
    any text row's."""
    import torch
    from repro_torch.serving import MMItem

    cfg, model, params = _full_width("qwen2-vl-2b")
    base = dict(kv_pool_bytes=4 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8)
    prompts = _prompts(8, cfg.vocab_size)
    sizes = np.random.default_rng(5).integers(64, 257, 4)
    sizes[2] = sizes[0]
    mm = [(MMItem(4, int(min(n, len(prompts[i]) - 8)),
                  mm_hash=(101, 202, 101, 303)[i]),)
          for i, n in enumerate(sizes)] + [()] * 4
    _warm(model, params, base, prompts)
    runs = {}

    def on_leg(eng, name, depth):
        runs[name, depth] = eng.encoder_runs

    rec = dict(async_scheduling=False, record_sample_logits=True)
    legs = [("packed", "packed", 1, rec),
            ("packed", "packed", 4, dict(async_scheduling=True,
                                         pipeline_depth=4)),
            ("packed-b256", "packed", 1,
             dict(rec, max_num_batched_tokens=256)),
            ("padded", "padded", 1, rec)]
    outs, ref, launches = _serve_legs("vlm", cfg, model, params, base, legs,
                                      prompts, 32, mm_items=mm,
                                      on_leg=on_leg)
    _, bare, more = _serve_legs("vlm text-only", cfg, model, params, base,
                                [("text-only", "packed", 1, rec)], prompts,
                                32, on_leg=on_leg)
    for k in launches:
        launches[k] += more[k]
    if outs["packed", 1] != outs["packed", 4]:
        raise AssertionError("vlm packed: outputs differ across depths")
    want = {leg: (0 if leg[0] == "text-only" else 3) for leg in runs}
    if runs != want:
        raise AssertionError(f"vlm: encoder runs {runs}, expected {want}")
    noise, tol, forks = _forks_within_noise("vlm", ref, ("padded",))
    moved = {r.rid: float(np.abs(ref["packed"].sample_log[r.rid][0] -
                                 bare["text-only"].sample_log[r.rid][0]).max())
             for r in ref["packed"].finished}
    img = [moved[f"r{i}"] for i in range(4)]
    txt = [moved[f"r{i}"] for i in range(4, 8)]
    if not min(img) > max(txt):
        raise AssertionError(f"vlm: the image rows' first-token logits "
                             f"moved {img} without their images, text rows "
                             f"{txt}")
    log(f"[vlm] images of {sizes.tolist()} positions (r0 and r2 share "
        f"one): encoder runs per leg {runs}; outputs bitwise equal across "
        f"packed depths 1, 4; without the images the image rows' "
        f"first-token logits move by {[round(x, 4) for x in img]}, the "
        f"text rows' by {[round(x, 4) for x in txt]}; noise floor "
        f"{noise:.4f}, fork tolerance {tol:.4f}; (forks, first-token diff) "
        f"vs packed: {forks}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"card=[{card()}]")
    # the reference keeps no image pages (one full-attention KV type), so
    # its baseline allocates what Jenga does
    more = _baseline_legs("vlm", cfg, model, params, base, prompts, 32, tol,
                          expect="equal", mm_items=mm)
    for k in launches:
        launches[k] += more[k]
    _serve_fit(model, base, prompts, 32)
    return launches


def phase_moe_vlm():
    """Phase 7: the MoE family at full per-layer width, reduced depth
    (``MOE_CUTS``), one model after the other, then the VLM backbone at
    full width. Returns the kernel launch totals."""
    _moe_numerics()
    launches = {"varlen": 0, "paged": 0, "dense": 0}
    for arch, layers in MOE_CUTS:
        for k, n in _moe_model(arch, layers).items():
            launches[k] += n
    for k, n in _vlm().items():
        launches[k] += n
    return launches


# ----------------------------------------------------------------- phase 8
def _whisper():
    """whisper-tiny at full width (4 encoder + 4 decoder layers, d 384,
    6 / 6 heads of 64, vocab 51865, 1500 frames): phase 3's 8 prompts, 6
    of them carrying a 1500-frame stub clip (r0 and r2 the same clip) and
    2 text-only; packed at depths 1 and 4 (bitwise equal), packed-b256,
    padded and serial (fork-aware within twice the noise floor) and a
    seeded packed leg (temperature 0.8, top-k 50). Every leg counts 5
    encoder runs (the distinct clips, as the reference engine counts
    these requests; ``tests/test_torch_encdec.py`` holds the port's count
    to JAX's), launches the dense forward once an encoder layer in every
    dispatch that carries frames, the varlen kernel twice a decoder layer
    (self and cross) in every packed dispatch and the paged kernel once a
    decoder layer in every padded T == 1 dispatch."""
    import torch
    from repro_torch.serving import MMItem

    cfg, model, params = _full_width("whisper-tiny")
    base = dict(kv_pool_bytes=2 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8)
    prompts = _prompts(8, cfg.vocab_size)
    clips = (11, 12, 11, 13, 14, 15)
    enc = [(MMItem(0, cfg.encoder_seq, mm_hash=h),) for h in clips] + \
        [()] * 2
    _warm(model, params, base, prompts)
    runs = {}

    def on_leg(eng, name, depth):
        runs[name, depth] = eng.encoder_runs

    rec = dict(async_scheduling=False, record_sample_logits=True)
    legs = [("packed", "packed", 1, rec),
            ("packed", "packed", 4, dict(async_scheduling=True,
                                         pipeline_depth=4)),
            ("packed-b256", "packed", 1,
             dict(rec, max_num_batched_tokens=256)),
            ("padded", "padded", 1, rec), ("serial", "serial", 1, rec)]
    kw = dict(enc_items=enc, on_leg=on_leg,
              attn_layers=(2 * cfg.num_layers, cfg.num_layers))
    outs, ref, launches = _serve_legs("whisper", cfg, model, params, base,
                                      legs, prompts, 32, **kw)
    seeded, _, more = _serve_legs(
        "whisper seeded", cfg, model, params, base,
        [("seeded", "packed", 1, dict(async_scheduling=False))], prompts,
        32, sampling=dict(temperature=0.8, top_k=50, seed=42), **kw)
    for k in launches:
        launches[k] += more[k]
    if outs["packed", 1] != outs["packed", 4]:
        raise AssertionError("whisper packed: outputs differ across depths")
    if seeded["seeded", 1] == outs["packed", 1]:
        raise AssertionError("whisper: the seeded draw equals greedy")
    if set(runs.values()) != {len(set(clips))}:
        raise AssertionError(f"whisper: encoder runs {runs}, expected "
                             f"{len(set(clips))} a leg")
    noise, tol, forks = _forks_within_noise("whisper", ref,
                                            ("padded", "serial"))
    log(f"[whisper] clips of {cfg.encoder_seq} frames on r0-r5 (r0 and r2 "
        f"share one), r6 and r7 text-only: encoder runs per leg {runs}; "
        f"outputs bitwise equal across packed depths 1, 4; noise floor "
        f"{noise:.4f}, fork tolerance {tol:.4f}; (forks, first-token diff) "
        f"vs packed: {forks}; 0 leaked pages; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"card=[{card()}]")
    # depth 1: the reference's whisper engine preempts without end at
    # depth 4 on small pools; the phase's pool, the clips' rows and the
    # peak may tie (the baseline widens only rows without a clip)
    more = _baseline_legs("whisper", cfg, model, params, base, prompts, 32,
                          tol, depth=1, pressure=False, expect="at least",
                          enc_items=enc, text_only=("r6", "r7"),
                          attn_layers=kw["attn_layers"])
    for k in launches:
        launches[k] += more[k]
    _serve_fit(model, base, prompts, 32, enc_rows=base["max_running"])
    return launches


def _rwkv_launches(model, params, base, prompts):
    """The CUDA launches (kernels and copies) and device ms of one packed
    mixed step of rwkv6-3b (prefill chunks beside decodes) and of one of
    its layers (``rwkv6_packed`` on that step's stream), counted by
    torch.profiler: the step's serve call and its first layer call are
    replayed after the drain, three profiler windows each, and the most
    launches a window saw is kept (a window now and then lacks device
    events, see ``device_ms``). Returns (step launches, layer launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import blocks_seq as BS
    from repro_torch.serving import Engine, EngineConfig, Request, \
        SamplingParams

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if _dev_us(e) > 0]
        return (sum(e.count for e in evs),
                sum(_dev_us(e) for e in evs) / 1e3)

    eng = Engine(model, EngineConfig(**base), params=params, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p,
                           sampling=SamplingParams(max_new_tokens=4)))
    calls = {}
    dispatch, serve, packed = eng.runner.dispatch, model.serve_step, \
        BS.rwkv6_packed

    def first(name, fn):
        def call(*args, **kw):
            calls.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return call

    def capturing(params_, prep):
        sizes = [nt for _, nt, _ in prep.items]
        if "step" in calls or min(sizes) > 1 or max(sizes) == 1:
            return dispatch(params_, prep)
        model.serve_step = first("step", serve)
        BS.rwkv6_packed = first("layer", packed)
        calls["tokens"] = sum(sizes)
        try:
            return dispatch(params_, prep)
        finally:
            del model.serve_step
            BS.rwkv6_packed = packed

    eng.runner.dispatch = capturing
    eng.run_until_done()
    if "step" not in calls:
        raise AssertionError("rwkv: no packed mixed step was dispatched")
    got = {}
    for name, fn in (("step", serve), ("layer", packed)):
        args, kw = calls[name]
        got[name] = max(kernels(lambda: fn(*args, **kw)) for _ in range(3))
    stream = calls["layer"][0][1].shape[1]
    log(f"[rwkv] CUDA launches (torch.profiler, the most of 3 windows) and "
        f"device ms: one packed mixed step of {calls['tokens']} tokens over "
        f"{stream} stream slots: {got['step'][0]} launches, "
        f"{got['step'][1]:.3f} ms; one of its {model.cfg.num_layers} "
        f"layers (rwkv6_packed): {got['layer'][0]} launches, "
        f"{got['layer'][1]:.3f} ms; card=[{card()}]")
    del eng, calls
    return got["step"][0], got["layer"][0]


def _rwkv():
    """rwkv6-3b at full width, 4 of its 32 layers (d 2560, 40 heads of 64,
    ff 8960, vocab 65536, untied): phase 3's 8 prompts, packed at depths
    1 and 4
    (bitwise equal), packed-b256, padded and serial (fork-aware within
    twice the noise floor), every leg drained with no leaked page and
    state checkpoint copies made (prompts past 512 tokens). The path runs
    no attention kernel (plain torch: the reference has no TPU kernel
    here); the CUDA launches of one layer and of one packed mixed step
    are counted and printed."""
    import gc

    import torch

    cfg, model, params = _full_width("rwkv6-3b", num_layers=4)
    base = dict(kv_pool_bytes=4 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8)
    prompts = _prompts(8, cfg.vocab_size)
    _warm(model, params, base, prompts)
    step_k, layer_k = _rwkv_launches(model, params, base, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    copies = {}
    outs, ref, launches = _serve_legs(
        "rwkv", cfg, model, params, base, _leg_set(depths=(1, 4),
                                                   serial=True),
        prompts, 32, attn_layers=(0, 0), copies=copies)
    if outs["packed", 1] != outs["packed", 4]:
        raise AssertionError("rwkv packed: outputs differ across depths")
    made = {leg: kinds.count("checkpoint") for leg, kinds in copies.items()}
    if not all(made.values()):
        raise AssertionError(f"rwkv: legs without a state checkpoint copy "
                             f"{made}")
    noise, tol, forks = _forks_within_noise("rwkv", ref,
                                            ("padded", "serial"))
    log(f"[rwkv] outputs bitwise equal across packed depths 1, 4; state "
        f"checkpoint copies per leg {made}; {layer_k} CUDA launches a "
        f"layer, {step_k} a packed mixed step; noise floor {noise:.4f}, "
        f"fork tolerance {tol:.4f}; (forks, first-token diff) vs packed: "
        f"{forks}; 0 leaked pages; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"card=[{card()}]")
    _serve_fit(model, base, prompts, 32)
    del params
    return launches


def phase_encdec_rwkv():
    """Phase 8: the enc-dec family (whisper-tiny) and RWKV6 (rwkv6-3b) at
    full width, one after the other, then both reduced, card vs CPU.
    Returns the kernel launch totals."""
    launches = {"varlen": 0, "paged": 0, "dense": 0}
    for fn in (_whisper, _rwkv):
        for k, n in fn().items():
            launches[k] += n
    for arch in ("whisper-tiny", "rwkv6-3b"):
        phase_small_reference(arch)
    return launches


# ----------------------------------------------------------------- phase 9
SPEC_K = 3
POOL_BYTES = 2 << 30    # each spec engine's, solo engine's and shard's pool
CRASH_TICK = 4          # fleet leg (iv): shard 1 dies after this many ticks


def _sync(device):
    import torch
    if device != "cpu":
        torch.cuda.synchronize()


def _varlen_launches():
    from repro_torch.kernels.flash_attention import flash_attention_varlen
    return flash_attention_varlen.launches


def _spec_generate(sd, prompts, new_tokens, vocab):
    """Generate every prompt, one after the other, through ``sd``; return
    the outputs and, per request, the target's fp32 logits row behind
    each output token (the last prefill chunk's for the first token, the
    verify dispatch's for each accepted one) for the fork-aware check."""
    import types
    rounds, first = [], [None]
    verify, fetch = sd._verify_chain, sd.t_runner.fetch

    def recording_verify(treq, base, k):
        handles = verify(treq, base, k)
        rounds.append(handles)
        return handles

    def recording_fetch(handle, n):
        out = fetch(handle, n)
        first[0] = out[0][:vocab]
        return out

    sd._verify_chain = recording_verify
    sd.t_runner.fetch = recording_fetch
    finished, log = [], {}
    for i, p in enumerate(prompts):
        rounds.clear()
        n0 = len(sd.accept_lengths)
        out = sd.generate(p, new_tokens, rid=f"r{i}")
        rows = [first[0]]
        for handles, a in zip(rounds, sd.accept_lengths[n0:]):
            rows += [h.logits[0, :vocab].float().cpu().numpy()
                     for h in handles[:a + 1]]
        finished.append(types.SimpleNamespace(rid=f"r{i}", output=out))
        log[f"r{i}"] = rows[:len(out)]
        stats = sd.mgr.memory_stats()
        if stats.used_units != 0:
            raise AssertionError(f"spec r{i}: leaked pages: {stats}")
    return types.SimpleNamespace(finished=finished, sample_log=log)


def _plain_one_at_a_time(model, params, base, prompts, new_tokens, device):
    """The plain greedy ``Engine`` serving the prompts one after the other
    (the spec engine's traffic); returns the engine and the wall seconds."""
    from repro_torch.serving import Engine, EngineConfig, Request, \
        SamplingParams
    eng = Engine(model, EngineConfig(**base), params=params, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, sampling=SamplingParams(
            max_new_tokens=new_tokens)))
        eng.run_until_done()
    _sync(device)
    return eng, time.perf_counter() - t0


def _spec_legs(cfg, params, device, tol):
    """Speculative decoding at k 3 on 2 of phase 3's prompts, 32 new
    tokens each, one request at a time, against the plain greedy engine
    of the target with the same chunk size on the same traffic, fork-aware
    within ``tol`` (twice the noise floor of ``_fleet_legs``). Draft (a):
    the target's config cut to 4 layers with its own weights (seed 1), a
    smaller page, mostly rejecting (rollbacks); draft (b): the target's
    config and weights under the ``draft_`` prefix, mostly accepting
    (overlapped rounds)."""
    import dataclasses
    import gc
    import types

    from repro_torch.models import build_model
    from repro_torch.serving import SpecDecodeConfig, SpecDecodeEngine

    prompts = _prompts(8, cfg.vocab_size)[:2]
    new_tokens, chunk = 32, 256
    plain_cfg = dict(kv_pool_bytes=POOL_BYTES, max_num_batched_tokens=512,
                     chunk_size=chunk, max_running=8,
                     enable_prefix_caching=False, async_scheduling=False,
                     record_sample_logits=True)
    plain, plain_s = _plain_one_at_a_time(build_model(cfg), params,
                                          plain_cfg, prompts, new_tokens,
                                          device)
    n_out = sum(len(r.output) for r in plain.finished)
    plain_tps = n_out / plain_s
    log(f"[spec] plain greedy engine, one request at a time: "
        f"{len(plain.finished)} requests, {n_out} tokens in "
        f"{plain_s:.3f} s, output_tok_per_s={plain_tps:.1f}; fork "
        f"tolerance {tol:.4f}; card=[{card()}]")

    small = dataclasses.replace(cfg, num_layers=4)
    draft_a = build_model(small)
    legs = (("a", small, draft_a, draft_a.init(seed=1, device=device)),
            ("b", cfg, build_model(cfg), params))
    launches = 0
    for name, dcfg, dmodel, dparams in legs:
        sd = SpecDecodeEngine(build_model(cfg), dmodel, SpecDecodeConfig(
            k=SPEC_K, kv_pool_bytes=POOL_BYTES, chunk_size=chunk),
            target_params=params, draft_params=dparams, device=device)
        pages = {s.name: s.page_units for s in sd.mgr.specs}
        v0 = _varlen_launches()
        _sync(device)
        t0 = time.perf_counter()
        rec = _spec_generate(sd, prompts, new_tokens, cfg.vocab_size)
        _sync(device)
        wall = time.perf_counter() - t0
        varlen = _varlen_launches() - v0
        want = cfg.num_layers * sd.t_runner.dispatch_count + \
            dcfg.num_layers * sd.d_runner.dispatch_count
        if varlen != want:
            raise AssertionError(f"spec ({name}): {varlen} varlen launches, "
                                 f"expected {want}")
        diff = _first_row_diff(plain, rec)
        if diff > tol:
            raise AssertionError(f"spec ({name}): first-token logits differ "
                                 f"from the plain engine by {diff} > {tol}")
        forks = _fork_aware_equal(plain, rec, f"spec ({name})", tol)
        acc = sd.accept_lengths
        n_out = sum(len(r.output) for r in rec.finished)
        log(f"[spec] draft ({name}): {dcfg.num_layers} layers, pages "
            f"{pages}; k={SPEC_K}; {len(acc)} rounds, mean accept length "
            f"{np.mean(acc):.3f}, accept lengths "
            f"{np.bincount(acc, minlength=SPEC_K + 1).tolist()} (count of "
            f"0..{SPEC_K}), overlapped_rounds={sd.overlapped_rounds} "
            f"spec_rollback_pages={sd.spec_rollback_pages}; dispatches "
            f"target {sd.t_runner.dispatch_count} draft "
            f"{sd.d_runner.dispatch_count}, varlen launches {varlen} "
            f"(expected {want}); {n_out} tokens in {wall:.3f} s, "
            f"output_tok_per_s={n_out / wall:.1f} "
            f"({n_out / wall / plain_tps:.3f}x the plain engine); forks vs plain {forks}, first-token diff "
            f"{diff:.4f}; 0 used units; card=[{card()}]")
        if name == "a" and not sd.spec_rollback_pages:
            raise AssertionError("spec (a): no round rolled back")
        if name == "b" and not sd.overlapped_rounds:
            raise AssertionError("spec (b): no overlapped round")
        launches += varlen
        del sd, rec
        gc.collect()
    # the fork checks need only the plain engine's outputs and rows: its
    # pool and draft (a)'s weights go before leg (d)'s peaks are measured
    ref = types.SimpleNamespace(finished=plain.finished,
                                sample_log=plain.sample_log)
    del plain, legs, draft_a
    gc.collect()
    return launches + _spec_geometry_legs(cfg, params, device, tol, ref,
                                          prompts[0], chunk)


SPEC_GEOMETRY_LAYERS = 24   # leg (d)'s draft: granite-3-2b at 24 of 40 layers
SPEC_GEOMETRY_TOKENS = 16


def _spec_geometry_legs(cfg, params, device, tol, plain, prompt, chunk):
    """Leg (d) of the MAX geometry (``phase_max_geometry``): speculative
    decoding at k 3 with a draft of the target's widths at
    SPEC_GEOMETRY_LAYERS layers (its own random draw, seed 1), whose page
    (393,216 units) is not the target's (655,360): the LCM page is
    1,966,080 units, the MAX page 655,360. One request (phase 3's first
    prompt, SPEC_GEOMETRY_TOKENS new tokens) under "lcm" and under "max",
    PageSan on: outputs, accept lengths, the draft's proposals and its
    logits (``_recording_rounds``) bit for bit equal across the geometries,
    fork-aware equal to the plain engine's first tokens within ``tol``,
    varlen launches exact, 0 used units after; the most used units
    printed and the peak held to the planner (both models' weights, the
    shared pool of both types). ``plain``: the plain engine's finished
    requests and sampled rows. Returns the varlen launches."""
    import dataclasses
    import gc
    import types

    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.serving import SpecDecodeConfig, SpecDecodeEngine

    dcfg = dataclasses.replace(cfg, num_layers=SPEC_GEOMETRY_LAYERS)
    dmodel = build_model(dcfg)
    dparams = dmodel.init(seed=1, device=device)
    n = SPEC_GEOMETRY_TOKENS
    r0 = plain.finished[0]
    ref = types.SimpleNamespace(
        finished=[types.SimpleNamespace(rid=r0.rid, output=r0.output[:n])],
        sample_log={r0.rid: plain.sample_log[r0.rid][:n]})
    res, logits, launches = {}, {}, 0
    with _pagesan():
        for g in ("lcm", "max"):
            torch.cuda.reset_peak_memory_stats()
            tmodel = build_model(cfg)
            sd = SpecDecodeEngine(tmodel, build_model(dcfg),
                                  SpecDecodeConfig(k=SPEC_K,
                                                   kv_pool_bytes=POOL_BYTES,
                                                   chunk_size=chunk,
                                                   geometry_mode=g),
                                  target_params=params, draft_params=dparams,
                                  device=device)
            if sd.mgr.sanitizer is None:
                raise AssertionError("spec (d): PageSan is off")
            mgr, peak, layout = sd.mgr, [0, 0], sd.t_runner.layout
            alloc = mgr.allocate_for_tokens

            def allocating(seq, target, alloc=alloc, mgr=mgr, peak=peak,
                           layout=layout):
                ok = alloc(seq, target)
                st = mgr.memory_stats()
                peak[0] = max(peak[0], st.used_units)
                peak[1] = max(peak[1], sum(t.used * layout.stride(n) for n, t
                                           in st.per_type.items()))
                return ok

            mgr.allocate_for_tokens = allocating
            drafted = _recording_rounds(sd)
            v0 = _varlen_launches()
            _sync(device)
            t0 = time.perf_counter()
            rec = _spec_generate(sd, [prompt], n, cfg.vocab_size)
            _sync(device)
            wall = time.perf_counter() - t0
            varlen = _varlen_launches() - v0
            want = cfg.num_layers * sd.t_runner.dispatch_count + \
                dcfg.num_layers * sd.d_runner.dispatch_count
            if varlen != want:
                raise AssertionError(f"spec (d) {g}: {varlen} varlen "
                                     f"launches, expected {want}")
            geo = mgr.geometry
            terms = dryrun.serve_terms(
                tmodel, dryrun.pool_bytes(tmodel, POOL_BYTES, g,
                                          specs=mgr.specs),
                chunk, 1, len(prompt) + n)
            terms["weights"] += dryrun.weight_bytes(dmodel)
            _fit(f"spec (d) {g}: target and a {dcfg.num_layers}-layer "
                 "draft on one pool", terms, torch.cuda.max_memory_allocated())
            res[g] = (rec.finished[0].output, list(sd.accept_lengths),
                      [t for t, _ in drafted])
            logits[g] = b"".join(lg for _, lg in drafted)
            forks = _fork_aware_equal(ref, rec, f"spec (d) {g}", tol)
            log(f"[spec (d)] {g}: pages "
                f"{ {s.name: s.page_units for s in mgr.specs} }, large page "
                f"{geo.large_page_units} units x {geo.num_large_pages}, "
                f"strides target {sd.t_runner.page_strides} draft "
                f"{sd.d_runner.page_strides}; {len(sd.accept_lengths)} "
                f"rounds, accept lengths {sd.accept_lengths}; "
                f"peak_used_units={peak[0]} (held at the page strides: "
                f"{peak[1]}; pool {geo.total_units}); "
                f"dispatches target {sd.t_runner.dispatch_count} draft "
                f"{sd.d_runner.dispatch_count}, varlen launches {varlen}; "
                f"{n} tokens in {wall:.3f} s; forks vs plain {forks}; 0 used"
                f" units after; card=[{card()}]")
            launches += varlen
            del sd, rec
            gc.collect()
    if res["lcm"] != res["max"] or logits["lcm"] != logits["max"]:
        raise AssertionError(f"spec (d): max {res['max']} differs from lcm "
                             f"{res['lcm']} (draft logits equal: "
                             f"{logits['lcm'] == logits['max']})")
    rounds = res["max"][2]
    log(f"[spec (d)] outputs, accept lengths, the draft's {SPEC_K} "
        f"proposals in each of {len(rounds)} rounds (the first round's "
        f"{rounds[0][:SPEC_K]}) and the draft's fp32 logits bit for bit "
        "equal under lcm and max")
    return launches


def _recording_rounds(sd):
    """Record each round of ``sd`` as (its sampled tokens: the draft's k
    proposals then the verify chain's k + 1, the draft steps' fp32 logits
    rows as bytes), read at the round's own host sync. Returns the list
    the rounds are appended to."""
    import torch
    rounds, fetch = [], sd._fetch_round

    def recording(d_handles, v_handles):
        toks = fetch(d_handles, v_handles)
        rows = torch.stack([h.logits[0].float() for h in d_handles])
        rounds.append((toks, rows.cpu().numpy().tobytes()))
        return toks

    sd._fetch_round = recording
    return rounds


def _fleet_workload(vocab):
    """Phase 3's 8 prompts (wave 1) and 4 that share the first 512 tokens
    of r1, r0, r1 and r2 (wave 2), so that round-robin sends each sharer
    to the shard that does not hold its prefix."""
    prompts = _prompts(8, vocab)
    rng = np.random.default_rng(9)
    wave2 = [prompts[s][:512] + rng.integers(
        0, vocab, int(rng.integers(32, 97))).tolist() for s in (1, 0, 1, 2)]
    return prompts, wave2


def _serve_waves(fleet, waves, new_tokens, device):
    """Submit each wave and run the engine or fleet until it is done;
    returns the wall seconds."""
    from repro_torch.serving import Request, SamplingParams
    _sync(device)
    t0 = time.perf_counter()
    i = 0
    for wave in waves:
        for p in wave:
            fleet.submit(Request(rid=f"r{i}", prompt=p, sampling=SamplingParams(
                max_new_tokens=new_tokens)))
            i += 1
        fleet.run_until_done()
    _sync(device)
    return time.perf_counter() - t0


def _fleet_checks(label, fleet, n_req, n_layers):
    """Every request finished once, every shard drained with its
    invariants, and one varlen launch a layer of every dispatch."""
    rids = [r.rid for r in fleet.finished]
    if len(rids) != n_req or len(set(rids)) != n_req:
        raise AssertionError(f"{label}: {len(rids)} finishes of {n_req} "
                             "requests")
    engines = [sh.engine for sh in fleet.shards] \
        if hasattr(fleet, "shards") else [fleet]
    for i, eng in enumerate(engines):
        eng.mgr.check_invariants()
        stats = eng.mgr.memory_stats()
        if stats.used_units != 0:
            raise AssertionError(f"{label}: shard {i} leaked {stats}")
    return n_layers * sum(eng.runner.dispatch_count for eng in engines)


def _fleet_legs(cfg, params, device):
    """The data-parallel fleet on one card: 2 shards of 2 GiB each, the
    12 requests of ``_fleet_workload`` in two waves, 16 new tokens each.
    (i) a 1-shard fleet is bitwise the solo engine; (ii) cache-aware vs
    round-robin routing: more prefix-hit tokens, outputs fork-aware equal
    to solo; (iii) roles prefill/decode: zero prefill tokens on the decode
    shard, one handoff a request, each adopted page byte-equal to its
    source page before the source releases it; (iv) shard 1 crashed
    after 4 ticks (mid-prefill): every request finishes once, outputs
    fork-aware equal to (ii)'s. Then one engine packed at depth 2 with
    ``autotune_budgets``. Returns the varlen launches and the fork
    tolerance: twice the noise floor (the solo engine against itself at
    budget 256), at least TIE_FORK_TOL."""
    import gc

    import torch
    from repro_torch.models import build_model
    from repro_torch.serving import DPEngine, Engine, EngineConfig

    model = build_model(cfg)
    wave1, wave2 = _fleet_workload(cfg.vocab_size)
    waves, n_req, new_tokens = (wave1, wave2), 12, 16
    base = dict(kv_pool_bytes=POOL_BYTES, max_num_batched_tokens=512,
                chunk_size=256, max_running=8, async_scheduling=False,
                record_sample_logits=True)
    L = cfg.num_layers
    launches = 0

    def leg(label, fleet, extra=""):
        nonlocal launches
        v0 = _varlen_launches()
        wall = _serve_waves(fleet, waves, new_tokens, device)
        varlen = _varlen_launches() - v0
        want = _fleet_checks(label, fleet, n_req, L)
        if varlen != want:
            raise AssertionError(f"{label}: {varlen} varlen launches, "
                                 f"expected {want}")
        launches += varlen
        n_out = sum(len(r.output) for r in fleet.finished)
        if isinstance(fleet, DPEngine):
            stats = fleet.fleet_stats()
            extra = ", " + ", ".join(f"{k}={stats[k]}" for k in (
                "steps_per_shard", "requests_per_shard", "prefix_hit_tokens",
                "readmissions", "handoffs", "handoff_pages")) + extra
        log(f"[fleet] {label}: {n_out} tokens in {wall:.3f} s, "
            f"output_tok_per_s={n_out / wall:.1f}, varlen launches {varlen} "
            f"(expected {want}){extra}; 0 used units on every shard; "
            f"card=[{card()}]")
        return wall

    solo = Engine(model, EngineConfig(**base), params=params, device=device)
    solo_s = leg("solo", solo)
    b256 = Engine(model, EngineConfig(**dict(base, max_num_batched_tokens=256)),
                  params=params, device=device)
    leg("solo-b256", b256)
    noise = _first_row_diff(solo, b256)
    tol = max(TIE_FORK_TOL, 2 * noise)
    log(f"[fleet] noise floor (solo vs solo-b256 first-token logits) "
        f"{noise:.4f}, fork tolerance {tol:.4f}")
    del b256
    outs = {r.rid: list(r.output) for r in solo.finished}

    def fleet(n, **kw):
        return DPEngine(model, EngineConfig(**base), params=params,
                        num_shards=n, split_pool=False, device=device, **kw)

    one = fleet(1)
    leg("(i) 1 shard", one)
    if {r.rid: list(r.output) for r in one.finished} != outs:
        raise AssertionError("(i): the 1-shard fleet differs from solo")
    del one

    hits = {}
    ref_ii = None
    for policy in ("cache-aware", "round-robin"):
        dp = fleet(2, policy=policy)
        wall = leg(f"(ii) 2 shards {policy}", dp)
        hits[policy] = dp.fleet_stats()["prefix_hit_tokens"]
        forks = _fork_aware_equal(solo, dp, f"(ii) {policy}", tol)
        log(f"[fleet] (ii) {policy}: {solo_s / wall:.3f}x the solo "
            f"output tokens/s, "
            f"forks vs solo {forks}")
        if policy == "cache-aware":
            ref_ii = dp
        else:
            del dp
    if not hits["cache-aware"] > hits["round-robin"]:
        raise AssertionError(f"(ii): cache-aware hit {hits['cache-aware']} "
                             f"tokens, round-robin {hits['round-robin']}")

    dp = fleet(2, roles=["prefill", "decode"])
    adopted, copy_ms = [], []
    for sh in dp.shards:
        runner = sh.engine.runner
        adopt = runner.adopt_pages

        def checked(src, pairs, runner=runner, adopt=adopt):
            _sync(device)
            t0 = time.perf_counter()
            adopt(src, pairs)
            _sync(device)
            copy_ms.append((time.perf_counter() - t0) * 1e3)
            for name, s, d in pairs:
                size = runner.mgr.spec(name).page_units
                if not torch.equal(
                        src.buffer[s * size:(s + 1) * size].view(torch.int16),
                        runner.buffer[d * size:(d + 1) * size].view(
                            torch.int16)):
                    raise AssertionError(f"(iii): adopted page {d} differs "
                                         f"from source page {s} ({name})")
                adopted.append(size)

        runner.adopt_pages = checked
    leg("(iii) prefill/decode", dp)
    decode_prefill = sum(m.prefill_tokens for m in dp.shards[1].engine.metrics)
    if decode_prefill != 0 or len(dp.handoffs) != n_req or \
            len(adopted) != dp.fleet_stats()["handoff_pages"]:
        raise AssertionError(f"(iii): decode shard prefill tokens "
                             f"{decode_prefill}, {len(dp.handoffs)} handoffs "
                             f"of {n_req}, {len(adopted)} pages checked")
    forks = _fork_aware_equal(solo, dp, "(iii)", tol)
    log(f"[fleet] (iii): decode shard prefill tokens 0, {len(dp.handoffs)} "
        f"handoffs, {len(adopted)} adopted pages "
        f"({sum(adopted) * 2 / 2 ** 20:.1f} MiB) each byte-equal to its "
        f"source, copied in {sum(copy_ms):.3f} ms in all (the most for one "
        f"handoff {max(copy_ms):.3f} ms; host clock around a synchronised "
        f"copy); forks vs solo {forks}; card=[{card()}]")
    del dp

    dp = fleet(2)
    run = dp.run_until_done

    def crash_midway(max_ticks=10_000):
        if dp.tick == 0:            # wave 1: crash shard 1 mid-prefill
            for _ in range(CRASH_TICK):
                dp.step()
            if not dp.inject_crash(1):
                raise AssertionError("(iv): shard 1 held no request")
        return run(max_ticks)

    dp.run_until_done = crash_midway
    leg("(iv) shard 1 crashed", dp)
    forks = _fork_aware_equal(ref_ii, dp, "(iv)", tol)
    log(f"[fleet] (iv): every request finished once, "
        f"{dp.fleet_stats()['readmissions']} re-admitted; forks vs (ii) "
        f"{forks}")
    del dp, ref_ii

    tuned = Engine(model, EngineConfig(**dict(
        base, autotune_budgets=True, async_scheduling=True,
        pipeline_depth=2)), params=params, device=device)
    seed = (tuned.autotuner.budget, tuned.autotuner.prefill_cap)
    if seed[0] != 288:
        raise AssertionError(f"autotune seed budget {seed[0]}, expected 288")
    leg("autotune depth 2", tuned, f", seed budget {seed[0]} (prefill cap "
        f"{seed[1]}), {tuned.autotuner.adjustments} adjustments, final "
        f"budget {tuned.scheduler.cfg.max_num_batched_tokens} (prefill cap "
        f"{tuned.scheduler.cfg.max_prefill_tokens_per_step})")
    forks = _fork_aware_equal(solo, tuned, "autotune", tol)
    log(f"[fleet] autotune: forks vs solo {forks}")
    del tuned, solo
    gc.collect()
    return launches, tol


def phase_spec_fleet(device="cuda"):
    """Phase 9: speculative decoding and the data-parallel fleet on
    full-width granite-3-2b (random bf16 weights from seed 0). Returns the
    kernel launch totals."""
    cfg, _, params = _full_width("granite-3-2b")
    t0 = time.perf_counter()
    varlen, tol = _fleet_legs(cfg, params, device)
    varlen += _spec_legs(cfg, params, device, tol)
    log(f"[phase 9] {time.perf_counter() - t0:.1f} s")
    return {"varlen": varlen, "paged": 0, "dense": 0}


# ----------------------------------------------------------------- phase 5
TRAIN_LOSS_TOL = 1e-2   # card vs CPU losses, reduced granite (bf16 sums in another order)


def _poisoned(params):
    return {k: ({n: w * float("nan") for n, w in v.items()}
                if k == "layers" else v * float("nan"))
            for k, v in params.items()}


def _trace_train_step(tr, params, state, data, step):
    """One more full-width training step under ``torch.profiler`` (after
    the counted ones): wall ms, device kernel ms and busy share, and device
    time by kernel group. Returns (params, state)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, _ = tr.run(params, state, data, num_steps=step + 1,
                                  start_step=step)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if _dev_us(e) > 0 and
               str(getattr(e, "device_type", "")).endswith("CUDA")]
    groups = {}
    for e in kernels:
        key = e.key.lower()
        name = next((g for g, words in (
            ("dense_flash fwd", ("dense_fwd",)),
            ("dense_flash bwd", ("dense_dkv", "dense_dq", "dense_delta")),
            ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
            ("elementwise and copies", ("elementwise", "copy")),
            ("reductions", ("reduce",)),
        ) if any(w in key for w in words)), "other")
        ms, n = groups.get(name, (0.0, 0))
        groups[name] = (ms + _dev_us(e) / 1e3, n + e.count)
    dev_ms = sum(ms for ms, _ in groups.values())
    log(f"[train trace] one step under the profiler: wall {wall:.1f} ms, "
        f"device kernels {dev_ms:.1f} ms (busy share {dev_ms / wall:.3f}), "
        f"{sum(n for _, n in groups.values())} kernel launches")
    for name, (ms, n) in sorted(groups.items(), key=lambda x: -x[1][0]):
        log(f"[train trace]   {name}: {ms:.1f} ms over {n} launches "
            f"({ms / dev_ms:.3f} of device time)")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:12]:
        log(f"[train trace]   {_dev_us(e) / 1e3:9.2f} ms x{e.count:5d} "
            f"{e.key[:80]}")
    return params, state


def phase_train():
    """Training. (a) Full-width granite-3-2b with fp32 masters from seed 0,
    4 steps of 2 x 2048-token sequences in 2 micro-batches: finite losses,
    the dense kernels launched exactly 2 x 40 x micro x steps (forward; the
    2 is the recomputation) and 40 x micro x steps (backward) times, step
    ms, tokens/s and peak memory. (b) Reduced granite with the same fp32
    weights on the card and on the CPU: 3 steps' losses within
    TRAIN_LOSS_TOL, exact resume from a checkpoint (rtol 1e-5), and the NaN
    watchdog restoring."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels.flash_attention import (
        dense_flash_bwd, dense_flash_fwd, flash_attention_varlen)
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,
                                      TrainerConfig, init)
    from repro_torch.training.optimizer import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=ROOT / "build")
    try:
        # ---- (a) full width
        cfg = ARCHS["granite-3-2b"]
        micro, steps, seq, batch = 2, 4, 2048, 4
        tr = Trainer(build_model(cfg), AdamWConfig(),
                     TrainerConfig(micro_batches=micro, ckpt_every=1 << 30,
                                   ckpt_dir=f"{ckpt_root}/full"))
        t0 = time.perf_counter()
        params, state = tr.init_state(0, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params["layers"].values()) + \
            params["embed"].numel() + params["final_norm"].numel()
        log(f"[train] granite-3-2b full width: {cfg.num_layers} layers, "
            f"{n_params} params fp32, init {time.perf_counter() - t0:.2f} s")
        data = SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch,
                           mode="markov")
        # one step untimed and uncounted (cuBLAS handles, allocator)
        params, state, warm = tr.run(params, state, data, num_steps=1)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for fn in (dense_flash_fwd, dense_flash_bwd, flash_attention_varlen,
                   paged_decode_attention):
            fn.launches = 0
        params, state, hist = tr.run(
            params, state, data, num_steps=1 + steps, start_step=1,
            log_every=1, on_metrics=lambda s, m: times.append(
                m["sec_per_step"]))
        fwd, bwd = dense_flash_fwd.launches, dense_flash_bwd.launches
        other = flash_attention_varlen.launches + \
            paged_decode_attention.launches
        peak = torch.cuda.max_memory_allocated()
        if len(hist) != steps or not np.isfinite(hist).all() or tr.restores:
            raise AssertionError(f"full-width losses {hist} (restores "
                                 f"{tr.restores})")
        want = (2 * cfg.num_layers * micro * steps,
                cfg.num_layers * micro * steps)
        if (fwd, bwd) != want or other:
            raise AssertionError(f"dense (fwd, bwd) launches {(fwd, bwd)}, "
                                 f"expected {want}; serve kernels {other}")
        step_ms = 1e3 * float(np.mean(times))
        tok_s = batch * seq / (step_ms / 1e3)
        log(f"[train] full width: losses {[round(x, 4) for x in warm + hist]}"
            f" (first untimed) step_ms={[round(1e3 * t, 1) for t in times]} "
            f"mean_step_ms={step_ms:.1f} train_tok_per_s={tok_s:.1f} "
            f"peak_mem_gb={peak / 1e9:.2f} dense_fwd_launches={fwd} "
            f"dense_bwd_launches={bwd} (= 2 x {cfg.num_layers} x {micro} x "
            f"{steps} and {cfg.num_layers} x {micro} x {steps})")
        params, state = _trace_train_step(tr, params, state, data,
                                          1 + steps)
        del params, state, tr
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (b) reduced granite: card vs CPU, resume, watchdog
        rcfg = reduced(ARCHS["granite-3-2b"])
        adamw = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=200)
        rdata = SyntheticLM(rcfg.vocab_size, seq_len=32, global_batch=8,
                            mode="markov")

        def trainer(name, every=5):
            return Trainer(build_model(rcfg), adamw,
                           TrainerConfig(micro_batches=2, ckpt_every=every,
                                         ckpt_dir=f"{ckpt_root}/{name}"))

        cpu_tr = trainer("cpu", 1 << 30)
        cpu_p, cpu_s = cpu_tr.init_state(0, device="cpu")
        gpu_tr = trainer("gpu", 1 << 30)
        gpu_p = tree_map(lambda t: t.cuda(), cpu_p)
        _, _, h_cpu = cpu_tr.run(cpu_p, cpu_s, rdata, num_steps=3)
        _, _, h_gpu = gpu_tr.run(gpu_p, init(gpu_p), rdata, num_steps=3)
        diff = float(np.abs(np.array(h_cpu) - np.array(h_gpu)).max())
        if diff > TRAIN_LOSS_TOL:
            raise AssertionError(f"reduced card vs CPU losses {h_gpu} vs "
                                 f"{h_cpu}: {diff} > {TRAIN_LOSS_TOL}")
        tr1 = trainer("resume")
        p, s = tr1.init_state(0, device="cuda")
        p, s, hist = tr1.run(p, s, rdata, num_steps=12)
        tr2 = trainer("resume")
        p2, s2, _ = tr2.restore(10, device="cuda")
        _, _, hist2 = tr2.run(p2, s2, rdata, num_steps=12, start_step=10)
        if not np.allclose(hist[-2:], hist2, rtol=1e-5):
            raise AssertionError(f"resume: {hist[-2:]} vs {hist2}")
        _, _, hist3 = tr1.run(_poisoned(p), s, rdata, num_steps=14,
                              start_step=12)
        if tr1.restores < 1 or not np.isfinite(hist3).all():
            raise AssertionError(f"watchdog: restores {tr1.restores}, "
                                 f"losses {hist3}")
        log(f"[train] reduced granite card vs CPU losses {h_gpu} vs {h_cpu}"
            f" (max diff {diff:.2e}, tol {TRAIN_LOSS_TOL}); exact resume "
            f"steps 10-11 {hist2} vs {hist[-2:]} (rtol 1e-5); NaN watchdog "
            f"restored {tr1.restores}x, losses {hist3}")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    return dict(fwd_launches=fwd, bwd_launches=bwd, step_ms=step_ms,
                tok_s=tok_s, peak=peak)


# ---------------------------------------------------------------- phase 5c
MESH_CUT = 16       # leg (ii)'s granite depth: its 1 x 1 run fits one card
# (relative loss, relative gradient-norm) bars of leg (ii) against a run
# of the same function, by whether the meshes split the model: the CPU
# test's bars (tests/test_torch_mesh_train.py: loss 1e-4 / 2e-4 absolute
# at a loss of ~5.5) taken relative to the loss
MESH_TOLS = {False: (2e-5, 8.3e-3), True: (4e-5, 1e-2)}
# leg (ii)'s MoE layers: qwen3-moe cut to phase 5b's one layer for the
# pairs, and each 4 x 1 (EP 4) leg at the planner's largest depth for it
MOE_ARCH, DBRX = "qwen3-moe-235b-a22b", "dbrx-132b"


@contextlib.contextmanager
def _one_card_mesh(device):
    """A 1 x 1 ``(data, model)`` mesh of this process (NCCL on the card,
    gloo on the CPU): its ``Dist``, whose collectives all have one rank."""
    import shutil
    import tempfile

    import torch.distributed as td
    from repro_torch.launch.mesh import make_dist
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_mesh_", dir=ROOT / "build")
    td.init_process_group("nccl" if device == "cuda" else "gloo",
                          init_method=f"file://{tmp}/store", rank=0,
                          world_size=1)
    try:
        yield make_dist((1, 1))
    finally:
        td.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _leaf_norms(grads, shards, dist):
    """Each leaf's gradient norm over its global leaf: the sum of squares
    of this rank's part, summed over the mesh axes the leaf is split on."""
    out = {}

    def walk(g, sh, prefix):
        for k in sorted(g):
            if isinstance(g[k], dict):
                walk(g[k], sh[k], f"{prefix}{k}.")
                continue
            sq = g[k].float().square().sum()
            if sh[k].split_model:
                sq = dist.all_reduce(sq, "model")
            if sh[k].data_dim is not None:
                sq = dist.all_reduce(sq, "data")
            out[prefix + k] = float(sq.sqrt())
    walk(grads, shards, "")
    return out


def _family_extra(cfg):
    """``Trainer.extra_batch`` of a family's phase-5b batch: the VLM's
    image span, enc-dec's frames; None for the others."""
    return {"vlm": lambda: _image_batch(cfg, 5),
            "encdec": lambda: _frame_batch(cfg, 5)}.get(
        cfg.family, lambda: None)()


def _step_batch(cfg, data, extra, device):
    """(tokens, targets, extras) of ``data``'s step 0 on ``device``."""
    import torch
    tok, tgt = data.batch_at(0)
    extras = {k: torch.as_tensor(np.asarray(v)).to(device)
              for k, v in (extra(tok) if extra else {}).items()}
    return (torch.from_numpy(tok).to(device),
            torch.from_numpy(tgt).to(device), extras)


def _routing(calls, replay=None):
    """A ``blocks_attn.moe_route`` that appends each call's top-k experts
    to ``calls`` and, given ``replay`` (another run's ``calls``), routes
    every call by that run's experts instead (call i by replay[i %
    len(replay)]: a step repeated takes the same routing again): the
    gates this run's probabilities at them, their queue places as
    ``moe_route`` counts them."""
    import torch
    from repro_torch.models import blocks_attn as BA
    route = BA.moe_route

    def fn(tok, router, *, num_experts, top_k, capacity_factor):
        gates, idx, slot, cap = route(tok, router, num_experts=num_experts,
                                      top_k=top_k,
                                      capacity_factor=capacity_factor)
        calls.append(idx.cpu().numpy())
        if replay is None:
            return gates, idx, slot, cap
        idx = torch.as_tensor(replay[(len(calls) - 1) % len(replay)],
                              device=tok.device)
        gates = BA.moe_probs(tok, router).gather(1, idx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return gates, idx, BA.moe_slots(idx, num_experts, cap), cap
    return fn


def _mesh_rank(dist, dev, cfg, micro, seq, batch, steps, replay=None):
    """Leg (ii) on one card: ``cfg`` on its rank of the mesh, weights from
    seed 0 (the one-card draw's slices), its family's phase-5b batch: the
    first step's loss and leaf gradient norms (a MoE's top-k experts of
    every ``moe_route`` call recorded; with ``replay``, a list by data
    rank of another run's, routed by those), then ``steps`` Trainer steps
    (ZeRO-1), with the card's peak, the planner's prediction for it and
    the bytes each kind of collective sent a step."""
    import tempfile

    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import blocks_attn, build_model
    from repro_torch.models.tp import Dist
    from repro_torch.training import SyntheticLM
    from repro_torch.training.optimizer import leaves
    cuda = dev.type == "cuda"
    model = build_model(cfg, dist)
    extra = _family_extra(cfg)
    calls = []
    with tempfile.TemporaryDirectory() as ckpt:      # never written
        tr = _mesh_trainer(model, micro, ckpt, extra)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        params, state = tr.init_state(0, device=dev)
        data = SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch,
                           mode="markov")
        route = blocks_attn.moe_route
        blocks_attn.moe_route = _routing(
            calls, None if replay is None else replay[dist.data_rank])
        try:
            loss, grads = tr.loss_and_grads(params, *_step_batch(
                cfg, data, extra, dev))
        finally:
            blocks_attn.moe_route = route
        norms = _leaf_norms(grads, model.shards(), dist)
        tr._release(params)
        del grads
        before = dict(dist.comm_bytes)
        times = []
        moments = sum(t.numel() for t in leaves(state.mu)) / sum(
            t.numel() for t in leaves(params))
        params, _, hist = tr.run(params, state, data, num_steps=steps,
                                 log_every=1, on_metrics=lambda s, m:
                                 times.append(m["sec_per_step"]))
        after = _leaf_norms(params, model.shards(), dist)
    comm = {k: (dist.comm_bytes[k] - before[k]) / steps for k in before}
    terms = dryrun.train_terms(build_model(cfg, Dist(
        dp=dist.dp, tp=dist.tp, pod=dist.pod, fsdp=dist.fsdp)),
        batch // dist.rows, seq, micro)
    return dict(loss=float(loss), norms=norms, hist=hist, routing=calls,
                moments=moments, after=after,
                step_ms=[1e3 * t for t in times],
                peak=torch.cuda.max_memory_allocated(dev) if cuda else None,
                terms=terms, comm=comm,
                card=torch.cuda.get_device_name(dev) if cuda else "cpu")


def _mesh_batch(cfg, device):
    """Phase 5's batch (the CPU dry run: rows of 288 tokens, which hold
    the VLM's image span): (micro, seq, batch, data, tokens, targets) of
    step 0."""
    import torch
    from repro_torch.training import SyntheticLM
    micro, seq, batch = 2, 2048 if device == "cuda" else 288, 4
    data = SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch,
                       mode="markov")
    tok, tgt = (torch.from_numpy(a).to(device) for a in data.batch_at(0))
    return micro, seq, batch, data, tok, tgt


def _mesh_trainer(model, micro, ckpt, extra=None):
    from repro_torch.training import AdamWConfig, Trainer, TrainerConfig
    return Trainer(model, AdamWConfig(), TrainerConfig(
        micro_batches=micro, ckpt_every=1 << 30, ckpt_dir=ckpt),
        extra_batch=extra)


def _mesh_leg_one(phase5_step_ms, device, cfg, dist):
    """Leg (i): ``cfg`` at full depth on the 1 x 1 mesh ``dist`` of this
    process against the single-card path on the same weights and batch.
    Returns the dense (fwd, bwd) launches of its 2 steps."""
    import gc
    import tempfile

    import torch
    from repro_torch.kernels.flash_attention import (dense_flash_bwd,
                                                     dense_flash_fwd)
    from repro_torch.launch import dryrun
    from repro_torch.models import DecoderLM

    cuda = device == "cuda"
    micro, seq, batch, data, tok, tgt = _mesh_batch(cfg, device)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        mesh = _mesh_trainer(DecoderLM(cfg, dist), micro, tmp)
        params, state = mesh.init_state(0, device=device)
        found = {}
        for tag, tr in (("single", _mesh_trainer(DecoderLM(cfg), micro,
                                                 tmp)), ("mesh", mesh)):
            dense_flash_fwd.launches = dense_flash_bwd.launches = 0
            loss, grads = tr.loss_and_grads(params, tok, tgt)
            found[tag] = (loss.item(), _leaf_norms(
                grads, mesh.model.shards(), dist),
                (dense_flash_fwd.launches, dense_flash_bwd.launches))
            tr._release(params)
            del grads
        if found["single"] != found["mesh"]:
            raise AssertionError(f"1 x 1 mesh {found['mesh'][:1]} differs "
                                 f"from the single-card path "
                                 f"{found['single'][:1]}")
        # the (pod, data, model) mesh of one rank: the same step's loss
        # and gradients as the 1 x 1 mesh's, bit for bit
        from repro_torch.launch.mesh import make_dist
        pod = _mesh_trainer(DecoderLM(cfg, make_dist((1, 1, 1))), micro, tmp)
        dense_flash_fwd.launches = dense_flash_bwd.launches = 0
        loss, grads = pod.loss_and_grads(params, tok, tgt)
        found["pod"] = (loss.item(), _leaf_norms(grads, mesh.model.shards(),
                                                 dist),
                        (dense_flash_fwd.launches, dense_flash_bwd.launches))
        pod._release(params)
        del grads, pod
        log(f"[mesh train] (i) 1 x 1 x 1 (pod, data, model) mesh, "
            f"{cfg.name}: loss {found['pod'][0]!r}, all "
            f"{len(found['pod'][1])} leaf gradient norms and launches "
            f"{found['pod'][2]} equal the 1 x 1 mesh's bit for bit: "
            f"{found['pod'] == found['mesh']}")
        if found["pod"] != found["mesh"]:
            raise AssertionError("the 1 x 1 x 1 pod mesh differs from the "
                                 "1 x 1 mesh")
        dense_flash_fwd.launches = dense_flash_bwd.launches = 0
        times = []
        params, state, hist = mesh.run(
            params, state, data, num_steps=3, start_step=1, log_every=1,
            on_metrics=lambda s, m: times.append(m["sec_per_step"]))
        launches = (dense_flash_fwd.launches, dense_flash_bwd.launches)
        want = (2 * cfg.num_layers * micro * 2, cfg.num_layers * micro * 2)
        if launches != want or not np.isfinite(hist).all():
            raise AssertionError(f"1 x 1 mesh steps: launches {launches} "
                                 f"(expected {want}), losses {hist}")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        step_ms = 1e3 * float(np.mean(times))
        loss0, norms = found["mesh"][:2]
        log(f"[mesh train] (i) 1 x 1 {'nccl' if cuda else 'gloo'} mesh, "
            f"{cfg.name} ({cfg.num_layers} layers), phase 5's batch and "
            f"weights: loss {loss0!r} and all {len(norms)} leaf gradient "
            f"norms equal the single-card path's bit for bit (embed "
            f"{norms['embed']!r}); steps 1-2 losses "
            f"{[round(x, 4) for x in hist]} "
            f"step_ms={[round(1e3 * t, 1) for t in times]} "
            f"mean_step_ms={step_ms:.1f} (phase 5: {phase5_step_ms:.1f}) "
            f"peak_mem_gb={peak / 1e9:.2f} dense_fwd_launches={launches[0]}"
            f" dense_bwd_launches={launches[1]}")
        if cuda:
            _fit(f"train {cfg.name} on a 1 x 1 mesh, {micro} x "
                 f"{batch // micro} x {seq}", dryrun.train_terms(
                     mesh.model, batch, seq, micro), peak)
        del params, state, mesh
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return launches


def _mesh_leg_family(tr, params, data, micro, batch, seq, counters, dist,
                     device):
    """Leg (i) for a phase-5b family (qwen3-moe, qwen2-vl-2b, zamba2-1.2b),
    on that leg's weights (``params``, before its first update), batch and
    depth: the same model built for the 1 x 1 mesh ``dist`` against the
    single-card path of ``tr``: the loss and every leaf's gradient norm
    bit for bit, the counted kernels launched ``_family_counts`` x micro
    times, and the peak of the mesh's step held to the planner. Returns
    the mesh step's launches."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model

    cfg = tr.model.cfg
    cuda = device == "cuda"
    batch_args = _step_batch(cfg, data, tr.extra_batch, device)
    mesh = _mesh_trainer(build_model(cfg, dist), micro, tr.tcfg.ckpt_dir,
                         tr.extra_batch)
    found = {}
    for tag, t in (("single", tr), ("mesh", mesh)):
        for fn in counters.values():
            fn.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        loss, grads = t.loss_and_grads(params, *batch_args)
        found[tag] = (loss.item(), _leaf_norms(grads, mesh.model.shards(),
                                               dist),
                      {k: fn.launches for k, fn in counters.items()})
        t._release(params)
        del grads
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    want = {k: v * micro for k, v in _family_counts(cfg).items()}
    if found["single"] != found["mesh"] or found["mesh"][2] != want:
        raise AssertionError(f"{cfg.name} 1 x 1 mesh {found['mesh'][0]} "
                             f"{found['mesh'][2]} differs from the "
                             f"single-card path {found['single'][0]} "
                             f"(launches expected {want})")
    loss, norms, got = found["mesh"]
    log(f"[mesh train] (i) 1 x 1 {'nccl' if cuda else 'gloo'} mesh, "
        f"{cfg.name} ({cfg.num_layers} layers), phase 5b's weights and "
        f"batch ({micro} x {batch // micro} x {seq}): loss {loss!r} and all "
        f"{len(norms)} leaf gradient norms equal the single-card path's "
        f"bit for bit; launches {got} (= {_family_counts(cfg)} x {micro}); "
        f"peak_mem_gb={peak / 1e9:.2f}")
    if cuda:
        _fit(f"train {cfg.name} at {cfg.num_layers} layers on a 1 x 1 mesh, "
             f"{micro} x {batch // micro} x {seq}", dryrun.train_terms(
                 mesh.model, batch, seq, micro), peak)
    return got


def _mesh_leg_steps(cfg, micro, batch, seq, want, counters, dist, device):
    """Leg (i) for a phase-5b RWKV6 or enc-dec leg: the model built for the
    1 x 1 mesh ``dist``, weights from seed 0 as the leg's, trained two
    steps on the leg's batch (``micro`` x ``batch // micro`` x ``seq``):
    both losses equal the leg's first two (``want``, the single-card path)
    bit for bit, the counted kernels launched ``_family_counts`` x micro x
    2 times, and the peak held to the planner. Returns the launches."""
    import tempfile

    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.training import SyntheticLM
    cuda = device == "cuda"
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        tr = _mesh_trainer(build_model(cfg, dist), micro, ckpt,
                           _family_extra(cfg))
        params, state = tr.init_state(0, device=device)
        data = SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch,
                           mode="markov")
        for fn in counters.values():
            fn.launches = 0
        params, state, hist = tr.run(params, state, data, num_steps=2)
        got = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        model = tr.model
        del params, state, tr
    expect = {k: v * micro * 2 for k, v in _family_counts(cfg).items()}
    line = (f"[mesh train] (i) 1 x 1 {'nccl' if cuda else 'gloo'} mesh, "
            f"{cfg.name} ({cfg.num_layers} layers), phase 5b's weights and "
            f"batch ({micro} x {batch // micro} x {seq}), two steps: losses "
            f"{hist} (single card {list(want[:2])}); launches {got} (= "
            f"{_family_counts(cfg)} x {micro} x 2); peak_mem_gb="
            f"{peak / 1e9:.2f}")
    log(line)
    if hist != list(want[:2]) or got != expect:
        raise AssertionError(f"mesh leg (i) {cfg.name}: {line}")
    if cuda:
        _fit(f"train {cfg.name} at {cfg.num_layers} layers on a 1 x 1 mesh, "
             f"{micro} x {batch // micro} x {seq}", dryrun.train_terms(
                 model, batch, seq, micro), peak)
    return got


def _one_card_ref(cfg, micro, seq, batch, device):
    """The first step's loss and leaf gradient norms of ``cfg`` on this
    process's card (no mesh), weights from seed 0 and its family's
    phase-5b batch; the memory is released after."""
    import gc
    import tempfile

    import torch
    from repro_torch.models import build_model
    from repro_torch.training import SyntheticLM
    extra = _family_extra(cfg)
    with tempfile.TemporaryDirectory() as ckpt:       # never written
        ref = _mesh_trainer(build_model(cfg), micro, ckpt, extra)
        params = ref.model.init(0, device=device, master=True)
        data = SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch,
                           mode="markov")
        loss, grads = ref.loss_and_grads(params, *_step_batch(
            cfg, data, extra, device))
        out = dict(loss=loss.item(), norms=_leaf_norms(
            grads, ref.model.shards(), ref.dist))
    del params, grads, ref, loss
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _mesh_run(label, cfg, shape, fsdp, micro, seq, batch, device, steps=3,
              ref=None, ref_label="", replay=None):
    """One leg (ii) mesh: ``cfg`` on a ``shape`` mesh, one process a card:
    each rank's step ms, peak against the planner's per-card prediction
    and bytes sent a step by each collective; all ranks' losses equal;
    with ``ref`` (a run of the same function: {"loss", "norms"}), the
    first step's loss and leaf norms within MESH_TOLS of it, and with
    ``replay`` (that run's routing by data rank) routed as it was, the
    tokens this mesh would route otherwise counted. Returns every rank's
    result."""
    from repro_torch.launch.mesh import run_mesh
    cuda = device == "cuda"
    t0 = time.perf_counter()
    ranks = run_mesh(_mesh_rank, shape, args=(cfg, micro, seq, batch, steps,
                                              replay),
                     fsdp=fsdp, backend="nccl" if cuda else "gloo",
                     device=device, timeout=300, deadline=900)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    tag = (f"{' x '.join(map(str, shape))}{' FSDP' if fsdp else ''}, "
           f"{cfg.name} at {cfg.num_layers} layers, {micro} x "
           f"{batch // micro} x {seq}")
    line = (f"[mesh train] (ii) {label}: {tag}, one process a card "
            f"({wall:.1f} s with start-up): first-step loss {r0['loss']!r}, "
            f"steps 0-{steps - 1} losses {[round(x, 4) for x in r0['hist']]}")
    bad = not np.isfinite(r0["hist"]).all() or \
        any(r["hist"] != r0["hist"] for r in ranks)
    if ref is not None:
        loss_tol, grad_tol = MESH_TOLS[shape[-1] > 1]
        worst = max(abs(r0["norms"][k] / v - 1) for k, v in
                    ref["norms"].items())
        rel = r0["loss"] / ref["loss"] - 1
        line += (f"; against {ref_label} {ref['loss']!r}: relative diff "
                 f"{rel:+.2e} (bar {loss_tol}), leaf gradient norms within "
                 f"{worst:.2e} relative (bar {grad_tol})")
        bad = bad or abs(rel) > loss_tol or worst > grad_tol
        if "after" in ref:
            moved = max(abs(r0["after"][k] / v - 1) for k, v in
                        ref["after"].items())
            line += (f"; leaf parameter norms after {steps} steps within "
                     f"{moved:.2e} relative (bar {grad_tol})")
            bad = bad or moved > grad_tol
    if replay is not None:
        mine = r0["routing"]
        other = sum(int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
                    for a, b in zip(mine, replay[0]))
        line += (f"; routed as {ref_label} routed, where this mesh's own "
                 f"top-k differs for {other} of "
                 f"{sum(len(a) for a in mine)} token routings (the "
                 f"forward's and the recomputation's)")
    log(line)
    for rank, r in enumerate(ranks):
        mb = {k: v / 1e6 for k, v in r["comm"].items()}
        log(f"[mesh train] (ii) {label} rank {rank} [{r['card']}]: step_ms="
            f"{[round(t, 1) for t in r['step_ms']]} peak_mem_gb="
            f"{(r['peak'] or 0) / 1e9:.2f} bytes sent a step: all-gather "
            f"{mb['all_gather']:.1f} MB, reduce-scatter "
            f"{mb['reduce_scatter']:.1f} MB, all-reduce "
            f"{mb['all_reduce']:.1f} MB, all-to-all {mb['all_to_all']:.1f} "
            f"MB; moments {r['moments']:.4f} of the params' elements")
        if cuda:
            _fit(f"train {tag}, rank {rank}", r["terms"], r["peak"])
    if bad:
        raise AssertionError(f"mesh leg (ii) {label}: {line}")
    return ranks


def _planner_depth(cfg, shape, micro, seq, batch):
    """The planner's largest fitting depth of ``cfg`` for a rank of a
    ``shape`` mesh taking ``batch // dp`` rows of ``seq`` tokens in
    ``micro`` micro-batches."""
    from repro_torch.launch import dryrun
    return dryrun.largest_depth(cfg, lambda c: dryrun.peak(
        dryrun.train_terms(dryrun.mesh_model(c, shape), batch // shape[0],
                           seq, micro)) <= dryrun.fit_bytes(shape))


def _mesh_leg_across(device, cfg, cards, moe_cfgs=None, ed_cfgs=None):
    """Leg (ii), one process a card: ``_mesh_legs_dense``,
    ``_mesh_legs_moe`` and, with 4 cards, ``_mesh_legs_encdec_rwkv_pod``.
    Skipped, and said so, with fewer than 2 cards. ``moe_cfgs`` and
    ``ed_cfgs``: the CPU dry run's reduced configs for (vlm, hybrid, moe,
    dbrx) and (whisper, rwkv)."""
    from repro_torch.configs import ARCHS
    if cards < 2:
        log(f"[mesh train] (ii) skipped: {cards} card visible "
            f"(torch.cuda.device_count()); its meshes (granite, qwen2-vl-2b, "
            f"zamba2-1.2b, qwen3-moe, dbrx-132b) need 2 cards, and 4 for "
            f"the 2 x 2, 4 x 1 and pod ones and whisper-tiny's and "
            f"rwkv6-3b's")
        return
    vlm, hybrid, moe, dbrx = moe_cfgs or (
        ARCHS["qwen2-vl-2b"], ARCHS["zamba2-1.2b"], ARCHS[MOE_ARCH],
        ARCHS[DBRX])
    _mesh_legs_dense(device, cfg, vlm, hybrid, cards >= 4)
    _mesh_legs_moe(device, moe, dbrx, cards >= 4, moe_cfgs is not None)
    if cards >= 4:
        whisper, rwkv = ed_cfgs or (ARCHS["whisper-tiny"],
                                    ARCHS["rwkv6-3b"])
        _mesh_legs_encdec_rwkv_pod(device, cfg, whisper, rwkv,
                                   ed_cfgs is not None)


# phase 5b's whisper batch: micro-batches, rows, decoder tokens a row
WHISPER_BATCH = (2, 16, 448)
RWKV_MESH_LAYERS = 8        # rwkv6-3b's depth on the 2 x 2 training leg


def _mesh_legs_encdec_rwkv_pod(device, cfg, whisper, rwkv, reduced=False):
    """The four-card training meshes of the enc-dec and RWKV6 families and
    of the pod axis: whisper-tiny 2 x 2 on phase 5b's batch (2 x 8 x 448
    over 1500 frames) against one card (tp 2 keeps its function);
    rwkv6-3b at RWKV_MESH_LAYERS layers 2 x 2 against 1 x 2 on the same
    global batch (``ln_x`` and ``cm_wv`` make tp another function, so
    both meshes take tp 2); granite (``cfg``) at MESH_CUT layers on the
    (2, 2, 1) (pod, data, model) mesh against (1, 4, 1), which computes
    the same function (``_mesh_leg_pod``)."""
    import dataclasses
    micro, seq, batch, *_ = _mesh_batch(cfg, device)
    wm, wb, ws = WHISPER_BATCH if not reduced else (micro, batch, seq)
    _mesh_run(whisper.name, whisper, (2, 2), False, wm, ws, wb, device,
              steps=2, ref=_one_card_ref(whisper, wm, ws, wb, device),
              ref_label="one card")
    r8 = rwkv if reduced else dataclasses.replace(
        rwkv, num_layers=RWKV_MESH_LAYERS)
    ref = _mesh_run(r8.name, r8, (1, 2), False, micro, seq, batch, device,
                    steps=2)[0]
    _mesh_run(r8.name, r8, (2, 2), False, micro, seq, batch, device, steps=2,
              ref=ref, ref_label="1 x 2")
    _mesh_leg_pod(device, cfg)


def _mesh_leg_pod(device, cfg):
    """Granite (``cfg``) at MESH_CUT layers on the (2, 2, 1) (pod, data,
    model) mesh against (1, 4, 1), which computes the same function (one
    row a rank a micro-batch): the first loss bit for bit, the leaf
    gradient and parameter norms after two steps within MESH_TOLS, and
    each rank's moments the share of its parameters that ZeRO-1 over
    data, then pod, gives (the planner's ``mesh_train_bytes``: a quarter,
    but for leaves that no free dim of the pod size splits, which keep a
    half, as the reference's ``zero1_shardings`` keeps them)."""
    import dataclasses

    from repro_torch.launch import dryrun
    micro, seq, batch, *_ = _mesh_batch(cfg, device)
    c = dataclasses.replace(cfg, num_layers=min(MESH_CUT, cfg.num_layers))
    ref = _mesh_run(f"{c.name} 1 x 4 x 1", c, (1, 4, 1), False, micro, seq,
                    2 * batch, device, steps=2)[0]
    pod = _mesh_run(f"{c.name} pod", c, (2, 2, 1), False, micro, seq,
                    2 * batch, device, steps=2, ref=ref,
                    ref_label="1 x 4 x 1")
    plan = dryrun.mesh_train_bytes(dryrun.mesh_model(c, (2, 2, 1)))
    want = plan["moments"] / (2 * plan["params"])
    share = [r["moments"] for r in pod]
    log(f"[mesh train] (ii) pod: the (2, 2, 1) mesh's first loss "
        f"{pod[0]['loss']!r} against (1, 4, 1)'s {ref['loss']!r}: bit for "
        f"bit {pod[0]['loss'] == ref['loss']}; each rank's moments "
        f"{share[0]:.4f} of its parameters' elements (the planner's ZeRO-1 "
        f"over data and pod: {want:.4f}; (1, 4, 1): {ref['moments']:.4f})")
    if pod[0]["loss"] != ref["loss"] or \
            any(abs(x - want) > 1e-6 for x in share):
        raise AssertionError("mesh leg (ii) pod: not the (1, 4, 1) mesh's "
                             "function, or moments not ZeRO-1's split")


def _mesh_legs_dense(device, cfg, vlm, hybrid, four):
    """Each mesh against a run of the same function: granite (``cfg``) at
    MESH_CUT layers and the VLM, 2 x 1 (2 x 2 with ``four`` cards) FSDP
    against one card; the hybrid 2 x 1 against one card and, with four
    cards, 2 x 2 against 1 x 2 (its out_norm runs over a rank's heads, so
    tp moves the function)."""
    import dataclasses
    micro, seq, batch, *_ = _mesh_batch(cfg, device)
    for c in (dataclasses.replace(cfg, num_layers=min(MESH_CUT,
                                                      cfg.num_layers)), vlm):
        _mesh_run(c.name, c, (2, 2) if four else (2, 1), True, micro, seq,
                  batch, device, ref=_one_card_ref(c, micro, seq, batch,
                                                   device),
                  ref_label="one card")
    _mesh_run(hybrid.name, hybrid, (2, 1), False, micro, seq, batch, device,
              ref=_one_card_ref(hybrid, micro, seq, batch, device),
              ref_label="one card")
    if four:
        ref = _mesh_run(hybrid.name, hybrid, (1, 2), False, micro, seq,
                        batch, device)[0]
        _mesh_run(hybrid.name, hybrid, (2, 2), False, micro, seq, batch,
                  device, ref=ref, ref_label="1 x 2")


def _mesh_legs_moe(device, moe, dbrx, four, reduced=False):
    """The MoE meshes: with ``four`` cards dbrx-132b and qwen3-moe on 4 x 1
    (EP 4) at the planner's largest depth for it (``reduced``: the CPU dry
    run's whole reduced configs), 8 rows in 2 micro-batches; qwen3-moe at
    one layer 2 x 1 (EP 2) and, with four cards, 2 x 2 (EP 2 x
    expert-TP 2) against it. The capacity and aux loss are per data rank,
    so only meshes of one data size compute one function, and a router
    near-tie routes a token otherwise when tp moves the rounding: the
    2 x 2 run routes as the 2 x 1 run did and counts the tokens it would
    have routed otherwise."""
    import dataclasses
    micro, seq, batch, *_ = _mesh_batch(moe, device)
    if four:
        for c in (dbrx, moe):
            depth = c.num_layers if reduced else _planner_depth(
                c, (4, 1), micro, seq, 2 * batch)
            if depth == 0:
                raise AssertionError(f"{c.name}: no depth fits a 4 x 1 mesh")
            log(f"[mesh train] (ii) {c.name} on 4 x 1 (EP 4): the planner's "
                f"largest fitting depth for 8 x {seq} tokens in {micro} "
                f"micro-batches is {depth} of {c.num_layers} layers")
            _mesh_run(c.name, dataclasses.replace(c, num_layers=depth),
                      (4, 1), False, micro, seq, 2 * batch, device, steps=2)
    one = moe if reduced else dataclasses.replace(moe, num_layers=1)
    ref = _mesh_run(one.name, one, (2, 1), False, micro, seq, batch,
                    device)
    if four:
        _mesh_run(one.name, one, (2, 2), False, micro, seq, batch, device,
                  ref=ref[0], ref_label="2 x 1",
                  replay=[r["routing"] for r in ref])


def phase_mesh_train(phase5_step_ms, device="cuda", cfg=None, cards=None,
                     moe_cfgs=None, ed_cfgs=None):
    """Phase 5c, training across cards: full width through the mesh path
    (``build_model(cfg, dist)``, ``repro_torch.launch.mesh``) on NCCL. (i)
    granite-3-2b on a 1 x 1 mesh at full depth on phase 5's batch and
    weights: the loss and every leaf's gradient norm equal phase 5's
    single-card path bit for bit, the dense kernels launched 2 x 40 x
    micro (forward) and 40 x micro (backward) times a step, 2 timed steps
    beside phase 5's, the peak held to the planner; phase 5b runs the
    same leg for qwen3-moe, qwen2-vl-2b and zamba2-1.2b on its own
    weights and batch (``_mesh_leg_family``). (ii) With 2 or more cards,
    ``_mesh_leg_across``: each mesh's first-step loss and leaf gradient
    norms against a run of the same function within MESH_TOLS, each
    card's step time, peak against the planner's per-card prediction and
    bytes sent a step by each collective (the all-to-all of expert
    parallelism among them). With one card leg (ii) is skipped and says
    so. Returns the dense launches of leg (i).

    A CPU dry run (plain kernels, gloo, no memory checks) takes a reduced
    ``cfg``, a pretended count of ``cards`` and reduced ``moe_cfgs``."""
    import torch
    from repro_torch.configs import ARCHS
    cfg = cfg or ARCHS["granite-3-2b"]
    with _one_card_mesh(device) as dist:
        launches = _mesh_leg_one(phase5_step_ms, device, cfg, dist)
    _mesh_leg_across(device, cfg, torch.cuda.device_count()
                     if cards is None else cards, moe_cfgs, ed_cfgs)
    return launches


# ---------------------------------------------------------------- phase 5d
# A mesh step against one card (or another run of the same function) is
# held to twice the in-run noise floor: the distance, on one card, between
# the reference run and the same step with only the mesh's roundings
# emulated (``_tp_partials``: the o-projection and down products as tp
# bf16 partials summed in bf16) or, for a mesh held against its own plain
# attention, between the kernels and their plain versions. Measured
# relative to each row's largest logit, and to the largest written K/V.
# A floor below MESH_SERVE_MIN_FLOOR counts as that (an exact emulation).
MESH_SERVE_FLOOR_X = 2.0
MESH_SERVE_MIN_FLOOR = 1e-3
MESH_SERVE_KV0_ULPS = 2     # layer 0's written K/V: the same inputs
# (tokens already in pages, tokens this step) of each request of a step
SERVE_STEPS = {
    "packed": [(0, 256), (512, 200), (1024, 1), (896, 1), (768, 1),
               (896, 1), (300, 1), (64, 1)],
    "prefill": [(0, 128), (256, 64), (512, 32), (100, 16)],
    "decode": [(1024, 1), (512, 1), (2048, 1), (700, 1), (64, 1), (300, 1),
               (1500, 1), (900, 1)],
}
SP_ONE_CARD_LEN = 16384         # qwen2.5-32b's sp leg against one card
SP_MAX_LEN = 524288             # the reference's long_500k sequence


def _device_batch(arrs, dev):
    """A ``DecodeBatch`` of the host arrays on ``dev``."""
    import torch
    from repro_torch.models import DecodeBatch

    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    return DecodeBatch(**{f: conv(v) for f, v in arrs.items()})


def _pages(cfg, seqs):
    """Pages of each attention type a leg's pool holds for ``seqs`` (an
    enc-dec model's cross pages too: a clip of ``encoder_seq`` frames a
    sequence)."""
    tpp = cfg.tokens_per_page
    n = sum(-(-(o + k) // tpp) for o, k in seqs)
    if cfg.family == "encdec":
        n = max(n, len(seqs) * -(-cfg.encoder_seq // tpp))
    return n + 8


def _serve_buffer(model, units, seed, dev, pages, one=None, kv0=0):
    """A leg's unified buffer on ``dev`` (``input_specs.example_pool``
    layout): N(0, 1) bf16 K/V in the attention pages, N(0, 0.1) fp32
    state (bf16 pairs) in the state pages, drawn from ``seed``. With
    ``one`` (the one-card model) the pages are the one-card buffer's, a
    rank's share at tp: K/V heads ``kv0 ..`` of each attention page, and
    of an RWKV6 state page the wkv state of heads ``kv0 ..`` (``kv0`` the
    rank's first head) beside the whole token shifts."""
    import torch
    from repro_torch.launch.input_specs import example_pool
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    buf = torch.zeros(units, dtype=torch.bfloat16, device=dev)
    _, first, _ = example_pool(model, pages)
    views = model._layer_views(buf)
    for s in model.kv_specs():
        lo = first[s.name][0] * s.page_units
        n = first[s.name][1] * s.page_units
        if s.kind in ("mamba", "rwkv") and (one is None or s.kind == "mamba"):
            buf[lo:lo + n].view(torch.float32).normal_(0.0, 0.1,
                                                       generator=gen)
            continue
        if one is None:
            buf[lo:lo + n].normal_(generator=gen)
            continue
        if s.kind == "rwkv":
            rd, hs = one.rd, model.cfg.rwkv_head_size
            whole = torch.empty((first[s.name][1], views[s.name][1],
                                 rd["wkv_units"] + rd["shift_units"]),
                                dtype=torch.float32, device=dev)
            whole.normal_(0.0, 0.1, generator=gen)
            n_wkv = model.rd["wkv_units"]
            mine = buf[lo:lo + n].view(torch.float32).view(
                *whole.shape[:2], -1)
            mine[..., :n_wkv] = whole[..., kv0 * hs * hs:
                                      kv0 * hs * hs + n_wkv]
            mine[..., n_wkv:] = whole[..., rd["wkv_units"]:]
            del whole
            continue
        ps = one.page_shapes()[s.name]           # (2, TPP, KV, D)
        whole = torch.empty((first[s.name][1], views[s.name][1]) + ps,
                            dtype=torch.bfloat16, device=dev)
        whole.normal_(generator=gen)
        kvl = views[s.name][4]
        buf[lo:lo + n].view(whole.shape[:4] + (kvl, ps[-1])).copy_(
            whole[..., kv0:kv0 + kvl, :])
        del whole
    return buf


def _written_rows(model, arrs, units, layer0=False):
    """Row ids (rows of KVL * D units) of every K and V slot a batch's live
    write ids cover, in every layer of each attention type (with
    ``layer0`` layer 0 only), as an int64 numpy array (the same ids in the
    one-card buffer, whose rows are KV * D units, when the page ids
    are)."""
    out = []
    pos = arrs["positions"]
    import torch
    for s in model.kv_specs():
        if s.kind not in ("full_attn", "swa"):
            continue
        vp, nl, _, tpp, kvl, d = model._layer_views(
            torch.empty(units))[s.name]
        w = arrs["write_eids"][s.name].reshape(-1)
        p = pos.reshape(-1)
        live = w >= 0
        base = (w[live].astype(np.int64) * nl * 2 * tpp + p[live] % tpp)
        for layer in range(1 if layer0 else nl):
            for sel in (0, 1):
                out.append(base + (layer * 2 + sel) * tpp)
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _serve_counts():
    from repro_torch.kernels.flash_attention import (dense_flash_fwd,
                                                     flash_attention_varlen)
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.paged_attention import paged_decode_attention
    return {"varlen": flash_attention_varlen.launches,
            "paged": paged_decode_attention.launches,
            "scan": mk.mamba_chunk_scan_varlen.launches,
            "dense": dense_flash_fwd.launches}


def _serve_run(model, params, buf, arrs, layout, dev, repeat=1):
    """``repeat`` serve steps of one layout (the buffer's written pages
    written again each time): logits of the last, each step's ms (host
    clock around a synchronised step) and the kernel launches of the
    first step."""
    import torch
    batch = _device_batch(arrs, dev)
    times, launches = [], None
    for i in range(repeat):
        c0 = _serve_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits = model.serve_step(params, buf, batch,
                                  prefill=layout != "decode")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        if launches is None:
            launches = {k: v - c0[k] for k, v in _serve_counts().items()}
    return logits, times, launches


def _serve_terms(model, units, arrs, layout):
    """The planner's per-card terms for one serve step of ``arrs`` on
    ``model`` (one card or one rank) with a pool of ``units``."""
    from repro_torch.core.spec import BYTES_PER_UNIT
    from repro_torch.launch import dryrun
    tok = arrs["tokens"]
    rows = len(arrs["seq_lens"])
    ctx = 0 if layout == "decode" else sum(
        t.shape[-1] * t.shape[-2] for t in arrs["tables"].values()) * \
        model.cfg.tokens_per_page
    enc = arrs.get("enc_embeds")        # the encoder's rows of the step
    return dryrun.serve_terms(model, units * BYTES_PER_UNIT, tok.size, rows,
                              ctx, enc_rows=0 if enc is None else
                              enc.shape[0])


def _serve_rank(dist, dev, spec):
    """One rank of a serving mesh (leg ii): ``spec["cfg"]`` on this rank
    (weights from seed 0: the one-card draw's slices, or with
    ``spec["local"]`` the rank's own draw), then for each layout the
    rank's batch (``split_batch`` of the leg's (1, 1) example batch, or
    with ``spec["long"]`` one sequence of that many tokens split over its
    members) over its buffer (with ``spec["one_card"]`` the one-card
    buffer's heads, else its own random pages), ``spec["repeat"]`` steps:
    local logits, written K/V rows, step ms, launches, bytes by
    collective, peak and the planner's terms. ``spec["plain"]``: the
    attention kernels' plain versions instead (the same function)."""
    import dataclasses
    with _plain_attention() if spec.get("plain") else \
            contextlib.nullcontext():
        return _serve_rank_steps(dataclasses.replace(
            dist, sp=spec.get("sp", False)), dev, spec)


def _serve_rank_steps(dist, dev, spec):
    """``_serve_rank``'s work, under its attention. ``spec["rows_of"]``
    (a tp-only mesh): the step's rows as each data rank of a mesh of that
    many data ranks takes them, one after another."""
    import torch
    from repro_torch.launch.input_specs import example_batch, split_batch
    from repro_torch.models import build_model
    from repro_torch.models.tp import Dist
    cuda = dev.type == "cuda"
    cfg = spec["cfg"]
    model = build_model(cfg, dist)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(0, device=dev, **(
        {"local": True} if spec.get("local") else {}))
    one = build_model(cfg) if spec.get("one_card") else None
    # the rank's first K/V head (RWKV6: its first head) of the one-card
    # model's
    kv0 = dist.model_rank * model.rd["h_local"] if cfg.family == "ssm" \
        else (dist.model_rank // model.ri["repl"]) * model.kv_local
    kvl = getattr(model, "kv_local", 1)     # RWKV6 writes no K/V
    steps = spec.get("repeat", 2)
    out = {"card": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "init_peak": torch.cuda.max_memory_allocated(dev) if cuda
           else None}
    for layout in spec["layouts"]:
        if spec.get("long"):
            arrs, units = _long_sp_batch(model, spec["long"], dist)
            buf = torch.empty(units, dtype=torch.bfloat16, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(dist.rank)
            buf.normal_(generator=gen)
            parts = [arrs]
        else:
            seqs = spec["steps"][layout]
            pages = _pages(cfg, seqs)
            whole, units = example_batch(model, seqs, layout == "packed", 7,
                                         pages)
            # with rows_of: the rows each data rank of a dp-rank mesh
            # takes, one after another on this tp-only mesh
            split = build_model(cfg, Dist(dp=spec["rows_of"], tp=dist.tp,
                                          repl=dist.repl)) \
                if spec.get("rows_of") else model
            parts = [split_batch(whole, split, d, dist.model_rank)
                     for d in (range(spec["rows_of"]) if spec.get("rows_of")
                               else [dist.data_rank])]
            buf = _serve_buffer(model, units, 11 + (
                0 if one is not None else dist.model_rank), dev, pages,
                one, kv0)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = dict(dist.comm_bytes)
        replay = spec.get("replay", {}).get(layout)
        with _routed([], replay) if replay else contextlib.nullcontext():
            runs = [_serve_run(model, params, buf, a, layout, dev, steps)
                    for a in parts]
        logits = torch.cat([r[0] for r in runs])
        times = runs[0][1]
        launches = {k: sum(r[2][k] for r in runs) for k in runs[0][2]}
        arrs = parts[0]
        rows = np.concatenate([_written_rows(model, a, units)
                               for a in parts])
        kv = buf.view(-1, kvl * cfg.head_dim)[
            torch.from_numpy(rows).to(dev)]
        first = np.isin(rows, np.concatenate([
            _written_rows(model, a, units, True) for a in parts]))
        real = torch.arange(logits.shape[-1], device=dev) + \
            dist.model_rank * logits.shape[-1] < cfg.vocab_size
        out[layout] = dict(
            logits=logits.float().cpu().numpy(),
            finite=bool(torch.isfinite(logits[:, real]).all()),
            rows=rows, kv=kv.float().cpu().numpy(), kv0=kv0, first=first,
            step_ms=times, launches=launches,
            comm={k: (dist.comm_bytes[k] - before[k]) / steps
                  for k in before},
            peak=torch.cuda.max_memory_allocated(dev) if cuda else None,
            terms=_serve_terms(model, units, arrs, layout))
        del buf
    return out


def _long_sp_batch(model, length, dist):
    """One sequence of ``length`` tokens decoding its last token, on one
    rank of an ``sp`` mesh: its pages (page ``i`` on member ``i %
    members``, ``input_specs.page_member``) numbered 0 .. in its own pool
    of exactly them (plus the scratch page), the token's write kept on
    the member that holds its page. Returns (arrays, pool units)."""
    from repro_torch.launch.input_specs import SENTINEL_POS, page_member
    s = model.kv_specs()[0]
    tpp = s.tokens_per_page
    mi, members = page_member(model, dist.data_rank, dist.model_rank)
    n_pages = -(-length // tpp)
    mine = np.arange(mi, n_pages, members)
    i32 = np.int32
    pos = length - 1
    tables = np.full((1, 1, 1, len(mine) + 1), -1, i32)
    page_pos = np.full(tables.shape, SENTINEL_POS, i32)
    tables[0, 0, 0, :len(mine)] = np.arange(len(mine))
    page_pos[0, 0, 0, :len(mine)] = mine * tpp
    owner = (pos // tpp) % members == mi
    eid = int(np.searchsorted(mine, pos // tpp)) if owner else -1
    arrs = dict(tokens=np.array([[17]], i32), positions=np.array([[pos]], i32),
                seq_lens=np.array([length], i32), last_idx=np.zeros(1, i32),
                tables={s.name: tables}, page_pos={s.name: page_pos},
                write_eids={s.name: np.array([[[[eid]]]], i32)},
                state_eids={})
    for f in ("mm_embeds", "mm_mask", "mrope_pos", "enc_embeds",
              "enc_write_eids", "enc_lens", "seg_ids", "chunk_start",
              "seg_start_tok", "seg_last_tok", "page_seg"):
        arrs[f] = None
    return arrs, (len(mine) + 1) * s.page_units


@contextlib.contextmanager
def _tp_partials(tp, d_model):
    """One card computing the roundings of a tp-rank mesh: the
    o-projection and the MLP's down product as ``tp`` partial products
    over the rank's head / d_ff slices, each rounded to bf16 and summed in
    bf16 one after another (an all-reduce's roundings, in one order)."""
    from repro_torch.models import blocks_attn
    dense = blocks_attn.dense

    def partials(x, w, b=None):
        caller = sys._getframe(1).f_code.co_name
        if tp == 1 or b is not None or w.shape[-1] != d_model or \
                caller not in ("attn_compute", "attn_compute_padded",
                               "attn_decode", "mlp_block"):
            return dense(x, w, b)
        k = w.shape[0] // tp
        acc = None
        for i in range(tp):
            part = dense(x[..., i * k:(i + 1) * k], w[i * k:(i + 1) * k])
            acc = part if acc is None else (acc.float() + part.float()).to(
                part.dtype)
        return acc

    blocks_attn.dense = partials
    try:
        yield
    finally:
        blocks_attn.dense = dense


@contextlib.contextmanager
def _plain_attention():
    """The serve path's varlen and paged calls through their plain
    versions (the same function, in torch)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_varlen_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_plain)
    from repro_torch.models import blocks_attn
    saved = blocks_attn.flash_attention_varlen, \
        blocks_attn.paged_decode_attention
    blocks_attn.flash_attention_varlen = \
        lambda *a, blk_q=0, blk_k=0, kv_tiles=None, **k: \
        flash_attention_varlen_plain(*a, **k)
    blocks_attn.paged_decode_attention = paged_decode_attention_plain
    try:
        yield
    finally:
        blocks_attn.flash_attention_varlen, \
            blocks_attn.paged_decode_attention = saved


@contextlib.contextmanager
def _routed(calls, replay=None):
    """``blocks_attn.moe_route`` through ``_routing(calls, replay)``."""
    from repro_torch.models import blocks_attn
    route = blocks_attn.moe_route
    blocks_attn.moe_route = _routing(calls, replay)
    try:
        yield
    finally:
        blocks_attn.moe_route = route


def _serve_one_card(spec, dev, floor=None):
    """The one-card run a leg is held against: ``spec["cfg"]`` with the
    same weights (seed 0), example batches and buffer on one card:
    {layout: (logits, written K/V rows, their values (rows, KV, D), step
    ms, noise floor, the MoE layers' top-k experts by call)}. ``floor``
    (a context manager: ``_tp_partials`` or ``_plain_attention``) runs
    each step again, on a fresh buffer, under it and routed as the first
    run was; the noise floor is that run's (relative logit, relative K/V)
    distance from the first (``_serve_distance``). Its memory is released
    before it returns."""
    import gc

    import torch
    from repro_torch.launch.input_specs import example_batch
    from repro_torch.models import build_model
    cfg = spec["cfg"]
    model = build_model(cfg)
    params = model.init(0, device=dev)
    out = {}
    for layout in spec["layouts"]:
        seqs = spec["steps"][layout]
        pages = _pages(cfg, seqs)
        arrs, units = example_batch(model, seqs, layout == "packed", 7,
                                    pages)
        rows = _written_rows(model, arrs, units)
        idx = torch.from_numpy(rows).to(dev)
        runs, calls = [], []
        for i, ctx in enumerate([contextlib.nullcontext] +
                                ([floor] if floor else [])):
            buf = _serve_buffer(model, units, 11, dev, pages)
            with ctx(), _routed(calls if i == 0 else [],
                                calls if i else None):
                logits, times, _ = _serve_run(model, params, buf, arrs,
                                              layout, dev)
            kvl = getattr(model, "kv_local", 1)  # RWKV6 writes no K/V
            kv = buf.view(-1, kvl * cfg.head_dim)[idx]
            runs.append((logits.float().cpu().numpy(), kv.view(
                len(rows), kvl, cfg.head_dim).float().cpu()
                .numpy(), times))
            del buf
        noise = _serve_distance(runs[1][0], runs[0][0], runs[1][1],
                                runs[0][1], cfg.vocab_size) if floor else None
        out[layout] = (runs[0][0], rows, runs[0][1], runs[0][2], noise,
                       calls)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _serve_distance(got, want, got_kv, want_kv, vocab):
    """(relative logit distance: per row max |diff| over the row's largest
    |logit| of ``want``, relative K/V distance: max |diff| over the
    largest |K/V|; None without K/V)."""
    got, want = got[:, :vocab], want[:, :vocab]
    rel = float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())
    if got_kv is None or not want_kv.size:
        return rel, None
    return rel, float(np.abs(got_kv - want_kv).max() / np.abs(want_kv).max())


def _bf16_ulp(x):
    return float(np.exp2(np.floor(np.log2(max(abs(x), 1e-30))) - 7))


def _global_serve_logits(ranks, layout, shape, sp):
    """The reference's global logits from every rank's local ones: the
    vocabulary over the model ranks, padded rows over the data ranks."""
    dp, tp = shape
    rows = range(dp) if layout != "packed" and not sp else range(1)
    return np.concatenate([np.concatenate(
        [ranks[d * tp + m][layout]["logits"] for m in range(tp)], axis=-1)
        for d in rows], axis=0)


def _serve_leg(label, shape, spec, device, ref=None, ref_label="",
               plain_ref=None, plain_floor=None):
    """One leg (ii) mesh of ``spec`` (``_serve_rank``) on a ``shape`` mesh,
    one process a card (NCCL). Every layout's logits finite; with ``ref``
    (``_serve_one_card``'s, or a ``_serve_leg`` run's global logits) held
    to it by ``_serve_compare``. Logs each rank's step ms, peak against
    the planner,
    bytes a step by collective and launches. Returns (ranks, {layout:
    global logits}, launches of every rank summed)."""
    from repro_torch.launch.mesh import run_mesh
    from repro_torch.models.tp import replica_info
    cuda = device == "cuda"
    cfg = spec["cfg"]
    repl = replica_info(cfg.num_heads, cfg.num_kv_heads, shape[1])["repl"]
    t0 = time.perf_counter()
    ranks = run_mesh(_serve_rank, shape, args=(spec,),
                     backend="nccl" if cuda else "gloo", device=device,
                     timeout=300, deadline=1200, sp=spec.get("sp", False),
                     repl=repl)
    wall = time.perf_counter() - t0
    tag = (f"{cfg.name} at {cfg.num_layers} layers, {shape[0]} x "
           f"{shape[1]}{' sp' if spec.get('sp') else ''}"
           f"{' (plain attention)' if spec.get('plain') else ''}")
    launches = {"varlen": 0, "paged": 0, "scan": 0, "dense": 0}
    glob = {}
    for layout in spec["layouts"]:
        logits = _global_serve_logits(ranks, layout, shape, spec.get("sp"))
        glob[layout] = logits
        line = (f"[mesh serve] (ii) {label}: {tag}, {layout} "
                f"({wall:.1f} s for the mesh run with start-up): logits "
                f"{logits.shape}")
        bad = not all(r[layout]["finite"] for r in ranks)
        if ref is not None:
            line_r, bad_r = _serve_compare(ranks, layout, logits, ref[layout],
                                           cfg)
            line += f"; against {ref_label}: {line_r}"
            bad = bad or bad_r
        if plain_ref is not None:
            line_p, bad_p = _serve_compare(ranks, layout, logits,
                                           (plain_ref[layout],), cfg,
                                           plain_floor[layout])
            line += (f"; against the same mesh with the attention's plain "
                     f"versions: {line_p}")
            bad = bad or bad_p
        log(line)
        for rank, r in enumerate(ranks):
            x = r[layout]
            mb = {k: v / 1e6 for k, v in x["comm"].items()}
            log(f"[mesh serve] (ii) {label} {layout} rank {rank} "
                f"[{r['card']}]: step_ms="
                f"{[round(t, 2) for t in x['step_ms']]} launches "
                f"{x['launches']} bytes a step: all-reduce "
                f"{mb['all_reduce']:.2f} MB, combine {mb['combine']:.2f} MB, "
                f"all-to-all {mb['all_to_all']:.2f} MB, all-gather "
                f"{mb['all_gather']:.2f} MB; peak_mem_gb="
                f"{(x['peak'] or 0) / 1e9:.2f} (init "
                f"{(r['init_peak'] or 0) / 1e9:.2f})")
            for k in launches:
                launches[k] += x["launches"][k]
            if cuda and not spec.get("plain"):    # the port's path only
                _fit(f"serve {tag} {layout}, rank {rank}", x["terms"],
                     x["peak"])
        if bad:
            raise AssertionError(f"mesh serve leg (ii) {label}: {line}")
    return ranks, glob, launches


def _serve_compare(ranks, layout, logits, ref, cfg, floor=None):
    """A mesh step against a reference run of the same function (``ref``:
    (logits, written rows, their K/V (rows, KV, D), ..., noise floor) of
    one card, or (logits,) of another run) within MESH_SERVE_FLOOR_X
    times the noise floor (``floor``, else the reference's own; at least
    MESH_SERVE_MIN_FLOOR): the relative logit distance and, with K/V, the
    relative distance of every rank's written K/V from its heads of the
    reference's; every row's greedy token the reference's or a near tie
    there (the reference's gap between the two within twice the row's
    max diff); layer 0's writes (inputs the same but for GEMMs over head
    slices) within MESH_SERVE_KV0_ULPS ulps of their largest value.
    Returns (log line, failed)."""
    v = cfg.vocab_size
    got, want = logits[:, :v], ref[0][:, :v]
    floor = floor or (ref[4] if len(ref) > 4 else None) or (0.0, 0.0)
    bar = [MESH_SERVE_FLOOR_X * max(f or 0.0, MESH_SERVE_MIN_FLOOR)
           for f in floor]
    diff = np.abs(got - want).max(-1)
    rel, _ = _serve_distance(got, want, None, None, v)
    g, w = got.argmax(-1), want.argmax(-1)
    gap = want[np.arange(len(w)), w] - want[np.arange(len(w)), g]
    flips = int((g != w).sum())
    ties = int(((g != w) & (gap <= 2 * diff)).sum())
    line = (f"max abs logit diff {diff.max():.3e} (max |logit| "
            f"{np.abs(want).max():.3f}), relative {rel:.3e} (noise floor "
            f"{floor[0]:.3e}, bar {bar[0]:.3e}); greedy tokens differ in "
            f"{flips} of {len(w)} rows ({ties} near ties)")
    bad = not rel <= bar[0] or flips != ties
    if len(ref) > 2:
        order = np.argsort(ref[1])
        worst0 = worst = 0.0
        for r in ranks:
            x = r[layout]
            if not len(x["rows"]):
                continue
            pos = order[np.searchsorted(ref[1][order], x["rows"])]
            kvl = x["kv"].shape[1] // cfg.head_dim
            want_kv = ref[2][pos][:, x["kv0"]:x["kv0"] + kvl].reshape(
                x["kv"].shape)
            d = np.abs(x["kv"] - want_kv)
            f = x["first"]
            worst0 = max(worst0, float(d[f].max() / _bf16_ulp(
                np.abs(want_kv[f]).max())))
            worst = max(worst, float(d.max() / np.abs(ref[2]).max()))
        line += (f"; written K/V: layer 0 within {worst0:.2f} ulps (bar "
                 f"{MESH_SERVE_KV0_ULPS}), every layer within {worst:.3e} "
                 f"of the largest (noise floor {floor[1] or 0:.3e}, bar "
                 f"{bar[1]:.3e})")
        bad = bad or worst0 > MESH_SERVE_KV0_ULPS or not worst <= bar[1]
    return line, bad


def _serve_launches(cfg, layout, arrs):
    """The kernel launches of one enc-dec or RWKV6 serve step (None for the
    other families): whisper's encoder once a layer where the step
    carries frames (the dense forward), its decoder's self and cross
    attention once a layer each in a packed step (the varlen kernel), its
    self attention once a layer in a padded T == 1 step (the paged
    kernel); RWKV6 none."""
    if cfg.family not in ("encdec", "ssm"):
        return None
    out = {"varlen": 0, "paged": 0, "scan": 0, "dense": 0}
    if cfg.family == "ssm":
        return out
    n = cfg.num_layers
    if arrs.get("enc_embeds") is not None:
        out["dense"] = cfg.encoder_layers
    if layout == "packed":
        out["varlen"] = 2 * n
    elif layout == "decode":
        out["paged"] = n
    return out


def _serve_leg_one(device, legs):
    """Leg (i): each of ``legs`` ((cfg, layouts, steps)) on a 1 x 1 mesh of
    this process (NCCL on the card) against the single-card
    ``serve_step``, same weights, batch and buffer: logits and every byte
    of the buffer equal, and the same kernel launches. Returns the mesh
    runs' launches."""
    import gc

    import torch
    from repro_torch.launch.input_specs import example_batch, example_pool
    from repro_torch.models import build_model
    dev = torch.device(device)
    total = {"varlen": 0, "paged": 0, "scan": 0, "dense": 0}
    with _one_card_mesh(device) as dist:
        for cfg, layouts, steps in legs:
            one, mesh = build_model(cfg), build_model(cfg, dist)
            params = one.init(0, device=dev)
            for layout in layouts:
                pages = _pages(cfg, steps[layout])
                arrs, units = example_batch(one, steps[layout],
                                            layout == "packed", 7, pages)
                buf0 = _serve_buffer(one, units, 11, dev, pages)
                res = []
                for model in (one, mesh):
                    buf = buf0.clone()
                    res.append(_serve_run(model, params, buf, arrs, layout,
                                          dev) + (buf,))
                (l1, t1, n1, b1), (l2, t2, n2, b2) = res
                # the scratch page (the last large page, where dropped
                # writes land in no fixed order) excepted
                keep = units - example_pool(one, pages)[2]
                same_l = torch.equal(l1, l2)
                same_b = torch.equal(b1[:keep].view(torch.int16),
                                     b2[:keep].view(torch.int16))
                same = same_l and same_b
                log(f"[mesh serve] (i) {cfg.name} at {cfg.num_layers} layers "
                    f"on a 1 x 1 mesh, {layout} ({len(steps[layout])} "
                    f"requests): bit for bit equal to the single-card step: "
                    f"logits {same_l}, buffer (scratch page excepted) "
                    f"{same_b}; launches {n2} (single card {n1}); step ms "
                    f"{t2[0]:.2f} (single card {t1[0]:.2f})")
                # padded T > 1 attention is plain torch: no kernel
                # there; RWKV6 runs none
                want = _serve_launches(cfg, layout, arrs)
                if not same or n1 != n2 or (want is None and (
                        layout != "prefill" and not sum(n2.values()))) or \
                        (want is not None and n2 != want):
                    raise AssertionError(f"mesh serve leg (i) {cfg.name} "
                                         f"{layout}: not the single-card "
                                         f"step (launches expected {want})")
                for k in total:
                    total[k] += n2[k]
                del buf0, res
            del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return total


def _sp_max_length(cfg, shape):
    """The longest sequence, up to SP_MAX_LEN, whose sp decode the planner
    fits on each card of ``shape`` (one rank's weights, its pages and a
    step's activations), in halvings of SP_MAX_LEN."""
    from repro_torch.core.spec import BYTES_PER_UNIT
    from repro_torch.launch import dryrun
    from repro_torch.models.tp import Dist, replica_info
    from repro_torch.models import build_model
    repl = replica_info(cfg.num_heads, cfg.num_kv_heads, shape[1])["repl"]
    model = build_model(cfg, Dist(dp=shape[0], tp=shape[1], sp=True,
                                  repl=repl))
    page = model.kv_specs()[0].page_units
    length = SP_MAX_LEN
    while length > cfg.tokens_per_page:
        pages = -(-length // cfg.tokens_per_page) // (shape[0] * repl) + 2
        terms = dryrun.serve_terms(model, pages * page * BYTES_PER_UNIT, 1,
                                   1)
        if dryrun.peak(terms) <= dryrun.fit_bytes(shape):
            return length, terms
        length //= 2
    raise AssertionError(f"{cfg.name}: no sp decode fits a {shape} mesh")


def phase_mesh_serve(device="cuda", cards=None, cfgs=None, steps=None):
    """Phase 5d, serving across cards: ``serve_step`` of the dense, MoE,
    VLM and hybrid families on a ``(data, model)`` mesh (NCCL), its
    batches from ``input_specs.split_batch``. (i) On one
    card: granite-3-2b at full depth (a packed mixed step, a padded
    prefill, a padded decode) and zamba2-1.2b (a packed step) on a 1 x 1
    mesh, bit for bit the single-card step. (ii) With 4 cards (else
    skipped, and said so): granite 1 x 4 and dbrx-132b 1 x 4 at 8 layers
    against one card; qwen2-vl-2b 1 x 4 (its K/V heads replicated twice:
    the replica-group combine) against the same mesh with the
    attention's plain versions, and its distance to one card reported
    (the reference's combine sums partials of different q heads, ROADMAP
    queue 3); dbrx-132b at 40 layers (or the planner's largest depth);
    qwen2.5-32b 2 x 2 ``sp`` decoding one sequence, at
    SP_ONE_CARD_LEN against one card and at the planner's longest
    length; zamba2-1.2b 2 x 2 against 1 x 2 on each data rank's rows.
    Returns the launches of every mesh run, for the kernels line.

    A CPU dry run (plain kernels, gloo, no memory checks): ``cfgs`` a dict
    of reduced configs by arch, ``steps`` small step shapes and a
    pretended count of ``cards``."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    cfgs = cfgs or {}
    steps = steps or SERVE_STEPS

    def cfg_of(arch, **kw):
        return dataclasses.replace(cfgs.get(arch, ARCHS[arch]), **kw)

    zamba = cfg_of("zamba2-1.2b", **({} if cfgs else {"tokens_per_page":
                                                      19}))
    whisper = cfg_of("whisper-tiny")
    rwkv8 = cfg_of("rwkv6-3b", **({} if cfgs else {"num_layers": 8}))
    pfd = ("packed", "prefill", "decode")
    total = _serve_leg_one(device, [
        (cfg_of("granite-3-2b"), pfd, steps), (zamba, ("packed",), steps),
        (whisper, pfd, steps), (rwkv8, pfd, steps)])
    cards = torch.cuda.device_count() if cards is None else cards
    if cards < 4:
        log(f"[mesh serve] (ii) skipped: {cards} card visible "
            f"(torch.cuda.device_count()); its meshes (granite, qwen2-vl-2b, "
            f"dbrx-132b, whisper-tiny and rwkv6-3b 1 x 4, qwen2.5-32b 2 x 2 "
            f"sp, zamba2-1.2b, whisper-tiny and rwkv6-3b 2 x 2 and 1 x 2) "
            f"need 4 cards")
        return total
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        "cpu")

    def add(n):
        for k in total:
            total[k] += n[k]

    pd = ("packed", "decode")
    # granite: 8 K/V heads over 4 ranks, no replicas
    spec = dict(cfg=cfg_of("granite-3-2b"), layouts=pd, steps=steps,
                one_card=True)
    add(_serve_leg("granite", (1, 4), spec, device, _serve_one_card(
        spec, dev, _tp4(spec)), "one card")[2])
    # qwen2-vl-2b: 2 K/V heads over 4 ranks, two replicas a head
    spec = dict(cfg=cfg_of("qwen2-vl-2b"), layouts=pd, steps=steps,
                one_card=True)
    one = _serve_one_card(spec, dev, _plain_attention)
    _, plain, _ = _serve_leg("qwen2-vl plain", (1, 4), dict(spec, plain=True,
                                                           repeat=1), device)
    _, glob, n = _serve_leg("qwen2-vl", (1, 4), spec, device,
                            plain_ref=plain, plain_floor={
                                k: one[k][4] for k in pd})
    add(n)
    for layout in pd:
        v = spec["cfg"].vocab_size
        log(f"[mesh serve] (ii) qwen2-vl 1 x 4 {layout} against one card: "
            f"max abs logit diff "
            f"{np.abs(glob[layout][:, :v] - one[layout][0][:, :v]).max():.3e}"
            f" (not a bar: the reference's replica-group combine sums the "
            f"partials of different q heads)")
    # dbrx-132b: 8 layers against one card, then full depth
    # routed as the one-card run routed: a router near-tie that bf16
    # rounding flips moves a MoE's outputs far past the rounding itself
    spec = dict(cfg=cfg_of(DBRX, num_layers=8 if not cfgs else
                           cfg_of(DBRX).num_layers),
                layouts=pd, steps=steps, one_card=True)
    one = _serve_one_card(spec, dev, _tp4(spec))
    add(_serve_leg("dbrx", (1, 4), dict(spec, replay={
        k: one[k][5] for k in pd}), device, one,
        "one card at 8 layers, routed as it routed")[2])
    full = cfg_of(DBRX)
    depth = full.num_layers
    if not cfgs:
        from repro_torch.launch.dryrun import largest_depth
        depth = largest_depth(full, lambda c: _serve_peak(c, (1, 4), steps)
                              <= _fit_bound((1, 4)))
    log(f"[mesh serve] (ii) dbrx-132b 1 x 4: the planner fits {depth} of "
        f"{full.num_layers} layers with this leg's pool and steps")
    add(_serve_leg("dbrx full", (1, 4), dict(
        cfg=dataclasses.replace(full, num_layers=depth), layouts=pd,
        steps=steps, local=True, repeat=3), device)[2])
    # qwen2.5-32b: one long sequence, sequence-parallel over 2 data ranks
    qwen = cfg_of("qwen2.5-32b")
    short = 64 if cfgs else SP_ONE_CARD_LEN
    spec = dict(cfg=qwen, layouts=("decode",), steps={"decode": [
        (short - 1, 1)]}, one_card=True, sp=True)
    add(_serve_leg("qwen2.5-32b sp", (2, 2), spec, device, _serve_one_card(
        spec, dev, _tp4(spec, 2)), "one card")[2])
    length, terms = (256, None) if cfgs else _sp_max_length(qwen, (2, 2))
    log(f"[mesh serve] (ii) qwen2.5-32b 2 x 2 sp: the planner's longest "
        f"decode fits {length} tokens (of {SP_MAX_LEN})")
    add(_serve_leg("qwen2.5-32b sp long", (2, 2), dict(
        cfg=qwen, layouts=("decode",), long=length, sp=True, repeat=2),
        device)[2])
    # zamba2-1.2b: tp 2 on both meshes (tp moves the hybrid's function);
    # 1 x 2 takes each data rank's rows in turn, so that each GEMM has the
    # rows it has on 2 x 2 (cuBLAS rounds another row count otherwise)
    spec = dict(cfg=zamba, layouts=("prefill", "decode"), steps=steps)
    _, glob, n = _serve_leg("zamba2 1 x 2", (1, 2), dict(spec, rows_of=2),
                            device)
    add(n)
    ref = {k: (v,) for k, v in glob.items()}
    add(_serve_leg("zamba2 2 x 2", (2, 2), spec, device, ref,
                   "1 x 2 on each data rank's rows")[2])
    _mesh_serve_encdec_rwkv(device, dev, whisper, cfg_of("rwkv6-3b"), rwkv8,
                            steps, add)
    return total


def _mesh_serve_encdec_rwkv(device, dev, whisper, rwkv, rwkv8, steps, add):
    """Leg (ii) of the enc-dec and RWKV6 families. whisper-tiny 1 x 4 (its
    6 heads padded to 12: 3 q heads on 3 K/V heads a rank, two replicas a
    K/V head, so the self attention combines over each replica pair and
    the cross attention reads every cross page whole on every rank), a
    packed step with frames and a decode step, against the same mesh with
    the attention's plain versions (the floor: one card's kernels against
    their plain versions), its distance to one card reported (the
    replica combine sums a real head's partial with a padded head's:
    another function, ROADMAP queue 3); whisper-tiny and rwkv6-3b (8
    layers) 2 x 2 against 1 x 2 on each data rank's rows (prefill, with
    frames, and decode); rwkv6-3b at full depth 1 x 4 (a packed mixed
    step and a decode step), its distance to one card reported, not
    held to a bar (``ln_x`` over a rank's heads and ``cm_wv``'s diagonal
    blocks: tp moves the function)."""
    pd = ("packed", "decode")
    spec = dict(cfg=whisper, layouts=pd, steps=steps, one_card=True)
    one = _serve_one_card(spec, dev, _plain_attention)
    _, plain, _ = _serve_leg("whisper plain", (1, 4), dict(
        spec, plain=True, repeat=1), device)
    _, glob, n = _serve_leg("whisper", (1, 4), spec, device, plain_ref=plain,
                            plain_floor={k: one[k][4] for k in pd})
    add(n)
    for layout in pd:
        v = whisper.vocab_size
        log(f"[mesh serve] (ii) whisper-tiny 1 x 4 {layout} against one "
            f"card: max abs logit diff "
            f"{np.abs(glob[layout][:, :v] - one[layout][0][:, :v]).max():.3e}"
            f" (not a bar: the replica combine sums the partials of a real "
            f"and a padded q head)")
    for cfg in (whisper, rwkv8):
        spec = dict(cfg=cfg, layouts=("prefill", "decode"), steps=steps)
        _, glob, n = _serve_leg(f"{cfg.name} 1 x 2", (1, 2),
                                dict(spec, rows_of=2), device)
        add(n)
        add(_serve_leg(f"{cfg.name} 2 x 2", (2, 2), spec, device,
                       {k: (v,) for k, v in glob.items()},
                       "1 x 2 on each data rank's rows")[2])
    spec = dict(cfg=rwkv, layouts=pd, steps=steps, one_card=True)
    one = _serve_one_card(spec, dev)
    _, glob, n = _serve_leg("rwkv6-3b", (1, 4), spec, device)
    add(n)
    for layout in pd:
        v = rwkv.vocab_size
        got, want = glob[layout][:, :v], one[layout][0][:, :v]
        rel = float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())
        log(f"[mesh serve] (ii) rwkv6-3b 1 x 4 at {rwkv.num_layers} layers "
            f"{layout} against one card: max abs logit diff "
            f"{np.abs(got - want).max():.3e}, relative to each row's largest "
            f"{rel:.3e}; greedy tokens differ in "
            f"{int((got.argmax(-1) != want.argmax(-1)).sum())} of {len(got)}"
            f" rows (not a bar: tp moves RWKV6's function)")


def _tp4(spec, tp=4):
    """``_tp_partials`` at ``tp`` for the leg's model, as a factory."""
    return lambda: _tp_partials(tp, spec["cfg"].d_model)


def _fit_bound(shape):
    from repro_torch.launch import dryrun
    return dryrun.fit_bytes(shape)


def _serve_peak(cfg, shape, steps):
    """The planner's per-card peak of a leg (ii) rank of ``cfg`` on
    ``shape``: the largest of its packed and decode steps."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.input_specs import example_batch
    from repro_torch.models import build_model
    from repro_torch.models.tp import Dist, replica_info
    repl = replica_info(cfg.num_heads, cfg.num_kv_heads, shape[1])["repl"]
    model = build_model(cfg, Dist(dp=shape[0], tp=shape[1], repl=repl))
    peaks = []
    for layout in ("packed", "decode"):
        arrs, units = example_batch(model, steps[layout], layout == "packed",
                                    7, _pages(cfg, steps[layout]))
        peaks.append(dryrun.peak(_serve_terms(model, units, arrs, layout)))
    return max(peaks)


# ---------------------------------------------------------------- phase 5b
# (arch, depth cut, micro-batches, rows, tokens a row) of a phase-5b step;
# rwkv6-3b is cut to 4 of its 32 layers for time (its full-depth fit is the
# planner's to predict)
FAMILY_TRAIN = (("zamba2-1.2b", {}, 2, 4, 2048), ("qwen2-vl-2b", {}, 2, 4, 2048),
                ("qwen3-moe-235b-a22b", {"num_layers": 1}, 4, 4, 2048),
                ("rwkv6-3b", {"num_layers": 4}, 4, 4, 2048),
                ("whisper-tiny", {}, 2, 16, 448))
IMAGE_AT, IMAGE_GRID = 16, 16     # the VLM rows' image span: 16 x 16 patches


def _image_batch(cfg, seed, grid=IMAGE_GRID):
    """``Trainer.extra_batch`` for the VLM: per row one image span of
    ``grid`` x ``grid`` positions at IMAGE_AT, its embeddings drawn from
    ``seed`` and the step's first token, M-RoPE at (t, h, w) = (16, 16 +
    row, 16 + column) of the grid, the text after it from 16 + grid on."""
    n = grid * grid

    def extra(tokens):
        b, t = tokens.shape
        rng = np.random.default_rng([seed, int(tokens[0, 0])])
        emb = np.zeros((b, t, cfg.d_model), np.float32)
        emb[:, IMAGE_AT:IMAGE_AT + n] = 0.02 * rng.standard_normal(
            (b, n, cfg.d_model), dtype=np.float32)
        mask = np.zeros((b, t), bool)
        mask[:, IMAGE_AT:IMAGE_AT + n] = True
        pos = np.zeros((3, t), np.int32)
        pos[:, :IMAGE_AT] = np.arange(IMAGE_AT)
        cells = np.arange(n)
        pos[0, IMAGE_AT:IMAGE_AT + n] = IMAGE_AT
        pos[1, IMAGE_AT:IMAGE_AT + n] = IMAGE_AT + cells // grid
        pos[2, IMAGE_AT:IMAGE_AT + n] = IMAGE_AT + cells % grid
        pos[:, IMAGE_AT + n:] = IMAGE_AT + grid + np.arange(
            t - IMAGE_AT - n)
        return dict(mm_embeds=emb, mm_mask=mask,
                    mrope_pos=np.ascontiguousarray(
                        np.broadcast_to(pos[:, None], (3, b, t))))
    return extra


def _frame_batch(cfg, seed):
    """``Trainer.extra_batch`` for enc-dec: each row's ``encoder_seq`` stub
    frame embeddings, drawn from ``seed`` and the step's first token."""
    def extra(tokens):
        rng = np.random.default_rng([seed, int(tokens[0, 0])])
        return {"enc_embeds": rng.standard_normal(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model),
            dtype=np.float32)}
    return extra


def _family_counts(cfg):
    """Kernel launches of one micro-batch's forward and backward: the
    scan forward 2 x per Mamba2 layer (recomputation), its backward once;
    dense forward 2 x per attention call, backward once (enc-dec: the
    encoder's self attention and each decoder layer's self and cross
    attention); RWKV6 and the serving kernels none."""
    n_attn, n_scan = cfg.num_layers, 0
    if cfg.family == "hybrid":
        n_attn, n_scan = cfg.num_layers // cfg.attn_every, cfg.num_layers
    elif cfg.family == "ssm":
        n_attn = 0
    elif cfg.family == "encdec":
        n_attn = cfg.encoder_layers + 2 * cfg.num_layers
    return dict(scan_fwd=2 * n_scan, scan_bwd=n_scan, dense_fwd=2 * n_attn,
                dense_bwd=n_attn, varlen=0, paged=0)


def _train_fit(model, arch, batch, seq, micro, peak):
    """The planner against a phase-5b leg's peak (since before its init),
    and a leg cut in depth against its largest fitting depth."""
    from repro_torch.launch import dryrun

    def terms(m):
        return dryrun.train_terms(m, batch, seq, micro)

    _fit(f"train {arch} at {model.cfg.num_layers} layers, {micro} x "
         f"{batch // micro} x {seq}", terms(model), peak)
    _cut_fits(f"train {arch}", model.cfg, terms)


def phase_train_families(device="cuda"):
    """Training the hybrid, VLM, MoE, RWKV6 and enc-dec families. (a) Full
    width, fp32 masters from seed 0, AdamW, one untimed step and 2 timed
    ones of FAMILY_TRAIN's layout: zamba2-1.2b; qwen2-vl-2b with a seeded image
    span in every row (``_image_batch``); qwen3-moe-235b-a22b at full
    per-layer width cut to 1 of its 94 layers (a layer's fp32 masters,
    gradients and AdamW moments are 16 bytes x 2.49 B params = 39.8 GB,
    the untied embedding and head 16 x 1.24 B = 19.9 GB: 2 layers would
    not fit 80 GB) and to micro-batches of 1 x 2048 tokens (4 a step: the
    (2048, 151936) fp32 logits and their gradient, and the bf16 copies of
    the expert masters the products take, fit beside the 59.7 GB);
    rwkv6-3b at 4 of its 32 layers in micro-batches of 1 x 2048 tokens;
    whisper-tiny, 16 rows of
    448 decoder tokens (its decoder context) over 1500 seeded stub frames
    a row (``_frame_batch``) in 2 micro-batches. Each: finite losses (the
    MoE aux loss printed), every counted kernel's launches exactly
    ``_family_counts`` per micro-batch (RWKV6: none), ms per step,
    tokens/s (whisper: decoder tokens, and frames/s) and the peak memory
    since before the leg's init, within FIT_TOL of the fit planner's
    prediction for the same depth, batch and micro-batches; a leg cut in
    depth within the planner's largest fitting depth. Then phase 5c's leg
    (i) for the MoE, VLM and hybrid legs (``_mesh_leg_family``): the same
    model built for a 1 x 1 NCCL mesh against the single-card path on the
    leg's weights and batch, bit for bit.
    (b) Reduced configs with the same fp32 weights on the card and on the
    CPU: 3 steps' losses within TRAIN_LOSS_TOL each; the reduced hybrid,
    RWKV6 and enc-dec models resumed exactly from a checkpoint (rtol
    1e-5, as phase 5). Returns the launch counts."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels.flash_attention import (dense_flash_bwd,
                                                     dense_flash_fwd,
                                                     flash_attention_varlen)
    from repro_torch.kernels.mamba_scan import (mamba_chunk_scan_bwd,
                                                mamba_chunk_scan_varlen)
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.models import blocks_attn, build_model
    from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,
                                      TrainerConfig, init)
    from repro_torch.training.optimizer import tree_map

    t_phase = time.perf_counter()
    counters = dict(scan_fwd=mamba_chunk_scan_varlen,
                    scan_bwd=mamba_chunk_scan_bwd,
                    dense_fwd=dense_flash_fwd, dense_bwd=dense_flash_bwd,
                    varlen=flash_attention_varlen,
                    paged=paged_decode_attention)
    totals = dict.fromkeys(counters, 0)

    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="smoke_fam_", dir=ROOT / "build")
    stack = contextlib.ExitStack()
    try:
        # the 1 x 1 mesh of phase 5c (i)'s MoE, VLM and hybrid legs
        mesh_dist = stack.enter_context(_one_card_mesh(device))
        # ---- (a) full width
        steps = 2
        for arch, cut, micro, batch, seq in FAMILY_TRAIN:
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t_arch = time.perf_counter()
            cfg = dataclasses.replace(ARCHS[arch], **cut)
            tr = Trainer(build_model(cfg), AdamWConfig(),
                         TrainerConfig(micro_batches=micro,
                                       ckpt_every=1 << 30,
                                       ckpt_dir=f"{ckpt_root}/{arch}"),
                         extra_batch=_family_extra(cfg))
            t0 = time.perf_counter()
            params, state = tr.init_state(0, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            n_params = sum(p.numel() for p in _leaves(params))
            init_s = time.perf_counter() - t0
            data = SyntheticLM(cfg.vocab_size, seq_len=seq,
                               global_batch=batch, mode="markov")
            aux = []
            moe = blocks_attn.moe_aux

            def recording(*a, **kw):
                out = moe(*a, **kw)
                aux.append(out.detach())
                return out

            blocks_attn.moe_aux = recording
            try:
                params, state, warm = tr.run(params, state, data,
                                             num_steps=1)
                times = []
                for fn in counters.values():
                    fn.launches = 0
                aux.clear()
                params, state, hist = tr.run(
                    params, state, data, num_steps=1 + steps, start_step=1,
                    log_every=1,
                    on_metrics=lambda s, m: times.append(m["sec_per_step"]))
            finally:
                blocks_attn.moe_aux = moe
            got = {k: fn.launches for k, fn in counters.items()}
            want = {k: v * micro * steps
                    for k, v in _family_counts(cfg).items()}
            peak = torch.cuda.max_memory_allocated() if device == "cuda" \
                else 0
            if len(hist) != steps or not np.isfinite(hist).all() or \
                    tr.restores:
                raise AssertionError(f"{arch} losses {hist} (restores "
                                     f"{tr.restores})")
            if got != want:
                raise AssertionError(f"{arch} launches {got}, expected {want}")
            for k, n in got.items():
                totals[k] += n
            aux_line = ""
            if cfg.num_experts:
                # forward and recomputation each form it: the first of a
                # micro-batch's pair is its forward's
                vals = [float(a) for a in aux[::2]]
                if not vals or not np.isfinite(vals).all():
                    raise AssertionError(f"{arch} aux losses {vals}")
                aux_line = (f" aux_loss per micro-batch (layer 0) "
                            f"{[round(v, 6) for v in vals]}")
            step_ms = 1e3 * float(np.mean(times))
            tok_s = batch * seq / (step_ms / 1e3)
            rate = f"train_tok_per_s={tok_s:.1f}"
            if cfg.family == "encdec":
                rate = (f"train_decoder_tok_per_s={tok_s:.1f} frames_per_s="
                        f"{batch * cfg.encoder_seq / (step_ms / 1e3):.1f}")
            cut_s = (f" ({cfg.num_layers} of {ARCHS[arch].num_layers} layers)"
                     if cut else "")
            log(f"[train {arch}] full width{cut_s}, {micro} x {batch // micro}"
                f" rows of {seq} tokens a step: {n_params / 1e9:.3f} B "
                f"params fp32, init {init_s:.1f} s; losses "
                f"{[round(x, 4) for x in warm + hist]} (first untimed)"
                f"{aux_line}; step_ms={[round(1e3 * t, 1) for t in times]} "
                f"mean_step_ms={step_ms:.1f} {rate} "
                f"peak_mem_gb={peak / 1e9:.2f} launches {got} (= "
                f"{_family_counts(cfg)} x {micro} x {steps}); "
                f"{time.perf_counter() - t_arch:.1f} s [{card()}]")
            if device == "cuda":
                _train_fit(tr.model, arch, batch, seq, micro, peak)
            if cfg.family in ("moe", "vlm", "hybrid"):       # phase 5c (i)
                for k, n in _mesh_leg_family(tr, params, data, micro, batch,
                                             seq, counters, mesh_dist,
                                             device).items():
                    totals[k] += n
            del params, state, tr
            if cfg.family in ("ssm", "encdec"):               # phase 5c (i)
                gc.collect()
                if device == "cuda":
                    torch.cuda.empty_cache()
                for k, n in _mesh_leg_steps(cfg, micro, batch, seq,
                                            warm + hist, counters, mesh_dist,
                                            device).items():
                    totals[k] += n
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # ---- (b) reduced: card vs CPU, and exact resumes
        adamw = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=200)
        for arch, _, _, _, _ in FAMILY_TRAIN:
            rcfg = reduced(ARCHS[arch])
            rdata = SyntheticLM(rcfg.vocab_size, seq_len=64, global_batch=4,
                                mode="markov")
            extra = _image_batch(rcfg, 5, grid=4) \
                if rcfg.family == "vlm" else _family_extra(rcfg)

            def trainer(name, every=1 << 30):
                return Trainer(build_model(rcfg), adamw,
                               TrainerConfig(micro_batches=2,
                                             ckpt_every=every,
                                             ckpt_dir=f"{ckpt_root}/{name}"),
                               extra_batch=extra)

            cpu_tr = trainer(f"{arch}-cpu")
            cpu_p, cpu_s = cpu_tr.init_state(0, device="cpu")
            dev_p = tree_map(lambda t: t.to(device, copy=True), cpu_p)
            _, _, h_cpu = cpu_tr.run(cpu_p, cpu_s, rdata, num_steps=3)
            _, _, h_dev = trainer(f"{arch}-dev").run(
                dev_p, init(dev_p), rdata, num_steps=3)
            diff = float(np.abs(np.array(h_cpu) - np.array(h_dev)).max())
            if diff > TRAIN_LOSS_TOL:
                raise AssertionError(f"reduced {arch} card vs CPU losses "
                                     f"{h_dev} vs {h_cpu}")
            line = (f"[train {arch}] reduced card vs CPU losses {h_dev} vs "
                    f"{h_cpu} (max diff {diff:.2e}, tol {TRAIN_LOSS_TOL})")
            if rcfg.family in ("hybrid", "ssm", "encdec"):
                tr1 = trainer(f"{arch}-resume", every=5)
                p, s = tr1.init_state(0, device=device)
                _, _, hist = tr1.run(p, s, rdata, num_steps=7)
                tr2 = trainer(f"{arch}-resume")
                p2, s2, _ = tr2.restore(5, device=device)
                _, _, hist2 = tr2.run(p2, s2, rdata, num_steps=7,
                                      start_step=5)
                if not np.allclose(hist[-2:], hist2, rtol=1e-5):
                    raise AssertionError(f"{arch} resume: {hist[-2:]} vs "
                                         f"{hist2}")
                line += (f"; exact resume steps 5-6 {hist2} vs {hist[-2:]} "
                         f"(rtol 1e-5)")
            log(line)
    finally:
        stack.close()
        shutil.rmtree(ckpt_root, ignore_errors=True)
    log(f"[phase 5b] {time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------- phase 10
BASELINE_MAX_STEPS = 1000   # a baseline-phase leg that does not drain fails


def _baseline_legs(tag, cfg, model, params, base, prompts, new_tokens, tol,
                   depth=4, pressure=True, expect="above", mm_items=None,
                   enc_items=None, attn_layers=None, text_only=()):
    """Phase 10 for one full-width model, on its phase's weights: Jenga
    against the PagedAttention baseline (``memory_mode="paged-baseline"``,
    the paper's Figs. 13/14 comparison), packed at ``depth`` and padded,
    once in each mode under one pool, each leg capped at BASELINE_MAX_STEPS
    steps. With ``pressure``, both modes first run packed at the phase's
    own pool, where nothing defers: their peak used units are what each
    needs, and the baseline's must be above Jenga's (``expect`` "above")
    or equal to it ("equal": a model whose KV types the baseline treats
    as Jenga does). The pool of the four legs is then Jenga's peak plus
    2%, in whole large pages: Jenga must hold every request at once with
    no defer and no preemption, and the baseline, which needs more, must
    defer or preempt in the packed leg ("above"; padded at depth 1 holds
    no speculative pages and needs less). Without ``pressure`` the legs run at the
    phase's pool and the baseline's peak is at least Jenga's. Every leg
    drains with 0 leaked pages and the phase's launch counts; the
    baseline's greedy outputs are fork-aware equal to Jenga's in the same
    mode within ``tol`` (twice the phase's noise floor; bitwise for
    "equal"); with ``text_only`` (enc-dec), those rows hold cross pages
    under the baseline only. Logs per leg the peak used units, the most
    requests running at once, defers, preemptions and output tokens/s.
    Returns the kernel launch totals."""
    seen, stats = {}, {}
    launches = {"varlen": 0, "paged": 0, "dense": 0}
    modes = ("jenga", "paged-baseline")
    rec = dict(record_sample_logits=True)
    packed = dict(rec, async_scheduling=depth > 1, pipeline_depth=depth)
    with _allocation_peaks() as peaks:

        def on_step(eng, name, d):
            sched = eng.scheduler
            st = seen.setdefault((name, d), dict(running=0, cross=0))
            st["peak"] = peaks[eng.mgr]
            st["running"] = max(st["running"], len(sched.running))
            st["defers"], st["preempts"] = (sched.defer_count,
                                            sched.preemption_count)
            for r in sched.running:
                if r.rid in text_only:
                    st["cross"] = max(st["cross"], sum(
                        len(t) for n, t in r.seq.page_tables.items()
                        if n.endswith("cross_attn")))

        kw = dict(mm_items=mm_items, enc_items=enc_items,
                  attn_layers=attn_layers, on_step=on_step,
                  max_steps=BASELINE_MAX_STEPS, leg_stats=stats)
        pool = base["kv_pool_bytes"]
        if pressure:
            large = []
            _, _, more = _serve_legs(
                f"{tag} baseline-phase demand", cfg, model, params, base,
                [(f"{m}-demand", "packed", depth, dict(packed, memory_mode=m))
                 for m in modes], prompts, new_tokens,
                on_leg=lambda e, n, d: large.append(
                    e.mgr.geometry.large_page_units), **kw)
            for k in launches:
                launches[k] += more[k]
            pj, pb = (seen[f"{m}-demand", depth]["peak"] for m in modes)
            units = -(-int(1.02 * pj) // large[0]) * large[0]
            if (expect == "above") != (pb > pj) or \
                    (expect == "equal") != (pb == pj) or \
                    (expect == "above" and units >= pb):
                raise AssertionError(f"{tag}: peak used units at the "
                                     f"phase's pool: Jenga {pj}, baseline "
                                     f"{pb}, expected {expect}; pool {units}")
            pool = units * 2
        legs = [(f"{m}{sfx}", layout, d,
                 dict(cfg_kw, memory_mode=m, kv_pool_bytes=pool))
                for m in modes
                for sfx, layout, d, cfg_kw in (
                    ("", "packed", depth, packed),
                    ("-padded", "padded", 1,
                     dict(rec, async_scheduling=False)))]
        outs, ref, more = _serve_legs(f"{tag} baseline-phase", cfg, model,
                                      params, base, legs, prompts,
                                      new_tokens, **kw)
    for k in launches:
        launches[k] += more[k]
    forks = {}
    for sfx, d in (("", depth), ("-padded", 1)):
        j, b = (f"{m}{sfx}" for m in modes)
        rj, rb = ((n if d == 1 else f"{n} depth {d}") for n in (j, b))
        diff = _first_row_diff(ref[rj], ref[rb])
        if diff > tol:
            raise AssertionError(f"{tag} {rb}: first-token logits differ "
                                 f"from {rj} by {diff} > {tol}")
        forks[rb] = (_fork_aware_equal(ref[rj], ref[rb], f"{tag} {rb}",
                                       tol), round(diff, 4))
        sj, sb = seen[j, d], seen[b, d]
        if pressure and (sj["defers"] or sj["preempts"] or
                         sj["running"] != len(prompts)):
            raise AssertionError(f"{tag} {rj}: Jenga did not hold every "
                                 f"request at once: {sj}")
        # the pool is set by the packed leg: padded at depth 1 holds no
        # speculative pages and may fit the baseline
        bad = {"above": pressure and not sfx and
               not sb["defers"] + sb["preempts"],
               "equal": sb != sj or outs[b, d] != outs[j, d],
               "at least": sb["peak"] < sj["peak"]}[expect]
        if bad:
            raise AssertionError(f"{tag} {rb}: {sb} against Jenga's {sj} "
                                 f"(expected {expect})")
        if text_only and not sj["cross"] == 0 < sb["cross"]:
            raise AssertionError(f"{tag} {rb}: cross pages on the text-only "
                                 f"rows {sb['cross']}, Jenga's "
                                 f"{sj['cross']}")
    for (name, d), st in sorted(seen.items()):
        gib = (base["kv_pool_bytes"] if "demand" in name else pool) / 2 ** 30
        log(f"[{tag} baseline-phase] {name} depth={d} pool={gib:.3f} GiB: "
            f"peak_used_units={st['peak']} max_running={st['running']} "
            f"defers={st['defers']} preemptions={st['preempts']}"
            + (f" text_only_cross_pages={st['cross']}" if text_only else "")
            + f" output_tok_per_s="
            f"{stats[name, d]['tokens'] / stats[name, d]['wall_s']:.1f} "
            f"card=[{card()}]")
    log(f"[{tag} baseline-phase] baseline vs Jenga (forks, first-token "
        f"diff) within {tol:.4f}: {forks}; 0 leaked pages")
    return launches


@contextlib.contextmanager
def _allocation_peaks():
    """Yields {manager: the most used units right after any of its batch
    allocations}: the peak within a step, before an in-flight step
    completes and frees pages (``JengaKVCacheManager.allocate_for_batch``
    wrapped while the block runs)."""
    from repro_torch.core.manager import JengaKVCacheManager
    allocate = JengaKVCacheManager.allocate_for_batch
    peaks = {}

    def recording(mgr, *a, **k):
        ok = allocate(mgr, *a, **k)
        peaks[mgr] = max(peaks.get(mgr, 0), mgr.memory_stats().used_units)
        return ok

    JengaKVCacheManager.allocate_for_batch = recording
    try:
        yield peaks
    finally:
        JengaKVCacheManager.allocate_for_batch = allocate


# ----------------------------------------------------------- planner fits
FIT_TOL = 0.15      # |predicted / measured - 1| of a peak (the planner)
FITS = []           # (label, predicted bytes, measured bytes)


def _fit(label, terms, measured):
    """Hold the planner's predicted peak (``dryrun.peak`` of ``terms``,
    plus the batch) against a measured ``max_memory_allocated``."""
    from repro_torch.launch import dryrun
    pred = dryrun.peak(terms) + terms.get("batch", 0)
    err = pred / measured - 1
    FITS.append((label, pred, measured))
    parts = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in
                      [("weights", terms["weights"]), ("pool", terms["pool"])]
                      + sorted(terms["detail"].items()))
    log(f"[planner] {label}: predicted {pred / 1e9:.2f} GB ({parts}) "
        f"measured {measured / 1e9:.2f} GB: error {err:+.3f} (bound "
        f"{FIT_TOL}) card=[{card()}]")
    if abs(err) > FIT_TOL:
        raise AssertionError(f"planner {label}: predicted {pred} bytes, "
                             f"measured {measured}")


def _serve_fit(model, base, prompts, new_tokens, enc_rows=0, label=""):
    """The planner against a serving phase's peak allocated bytes since
    ``_full_width`` (or the caller) reset the count: its bf16 weights, its
    pool (of ``base``'s geometry) and the largest step any of its legs
    dispatches (padded T > 1: rows x chunk, both to powers of two; packed:
    the budget). A model served cut in depth must be within the planner's
    largest fitting depth at the same batch and pool."""
    import torch
    from repro_torch.launch import dryrun
    cfg = model.cfg
    rows = base["max_running"]
    step = max(base["max_num_batched_tokens"],
               (1 << (rows - 1).bit_length()) *
               (1 << (base["chunk_size"] - 1).bit_length()))
    ctx = rows * (max(map(len, prompts)) + new_tokens)

    def terms(m):
        return dryrun.serve_terms(m, dryrun.pool_bytes(
            m, base["kv_pool_bytes"], base.get("geometry_mode", "lcm")),
            step, rows, ctx, enc_rows)

    _fit(f"serve {cfg.name} at {cfg.num_layers} layers{label}",
         terms(model), torch.cuda.max_memory_allocated())
    _cut_fits(f"serve {cfg.name}", cfg, terms)


def _cut_fits(label, cfg, terms):
    """A model cut in depth must be within the planner's largest fitting
    depth for the same run (``terms``: a model -> its predicted terms)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    full = ARCHS[cfg.name]
    if cfg.num_layers == full.num_layers:
        return
    depth = dryrun.largest_depth(full, lambda c: dryrun.peak(
        terms(build_model(c))) <= dryrun.FIT_BYTES)
    log(f"[planner] {label}: cut to {cfg.num_layers} of {full.num_layers} "
        f"layers; the planner's largest fitting depth for the same batch "
        f"and pool is {depth}")
    if cfg.num_layers > depth:
        raise AssertionError(f"{label}: cut {cfg.num_layers} > the "
                             f"planner's {depth}")


# ---------------------------------------------------------------- phase 11
# (arch, shape) the planner measures on the card, and the kernels each runs
PLANNER_CELLS = (("granite-3-2b", "prefill_32k"),
                 ("granite-3-2b", "decode_32k"),
                 ("zamba2-1.2b", "train_4k"))


def phase_planner():
    """Phase 11: the one-card fit planner (``repro_torch.launch.dryrun``).
    Predicts every (arch x shape) of ``shapes_for`` (weights, pool and
    activation terms at full depth, whether it fits, its largest fitting
    depth, the analytic roofline terms), then runs PLANNER_CELLS on the
    card at the smaller of their full and largest fitting depth
    (``dryrun.measure``: a prefill cell as one packed dispatch of the
    card's 2 x 32,768 tokens, a decode cell as one padded T == 1 dispatch
    over 8 x 32,768 tokens of context, a train cell as one ``Trainer``
    step of 16 x 4096 tokens), each peak within FIT_TOL of its prediction,
    finite outputs, and each cell's kernels launched exactly as its path
    takes them (prefill: varlen once a layer; decode: paged once a layer;
    train: ``_family_counts`` a micro-batch). Returns the launch totals."""
    import gc

    import torch
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME, shapes_for
    from repro_torch.kernels.flash_attention import (dense_flash_bwd,
                                                     dense_flash_fwd,
                                                     flash_attention_varlen)
    from repro_torch.kernels.mamba_scan import (mamba_chunk_scan_bwd,
                                                mamba_chunk_scan_varlen)
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.launch import dryrun

    _, total = torch.cuda.mem_get_info()
    log(f"[planner] the card reports {total / 2 ** 30:.2f} GiB "
        f"({total / 1e9:.2f} GB); the planner's card "
        f"{dryrun.CARD_BYTES / 2 ** 30:.2f} GiB less a "
        f"{dryrun.RESERVE / 2 ** 30:.0f} GiB reserve: cells fit below "
        f"{dryrun.FIT_BYTES / 1e9:.2f} GB")
    if abs(total - dryrun.CARD_BYTES) > 0.01 * dryrun.CARD_BYTES:
        raise AssertionError(f"the card has {total} bytes, the planner "
                             f"assumes {dryrun.CARD_BYTES}")
    recs = {}
    for arch in sorted(ARCHS):
        for shape in shapes_for(ARCHS[arch]):
            r = recs[arch, shape.name] = dryrun.plan(arch, shape.name)
            t_c, t_m = (r["roofline"][k] for k in ("t_compute_s",
                                                   "t_memory_s"))
            log(f"[planner] {arch} {shape.name}: {r['rows']} x "
                f"{r['tokens']} tokens; predicted peak "
                f"{r['peak_bytes'] / 1e9:.2f} GB at {r['full_depth']} "
                f"layers (weights {r['terms']['weights'] / 1e9:.2f}, pool "
                f"{r['terms']['pool'] / 1e9:.2f}, activations "
                f"{r['terms']['activations'] / 1e9:.2f}); fits="
                f"{r['fits']} largest_depth={r['max_depth']}; compute "
                f"{t_c:.3e} s, memory {t_m:.3e} s")
    counters = dict(varlen=flash_attention_varlen,
                    paged=paged_decode_attention,
                    scan_fwd=mamba_chunk_scan_varlen,
                    scan_bwd=mamba_chunk_scan_bwd,
                    dense_fwd=dense_flash_fwd, dense_bwd=dense_flash_bwd)
    totals = dict.fromkeys(counters, 0)
    for arch, shape in PLANNER_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        rec = recs[arch, shape]
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        m = dryrun.measure(rec)
        got = {k: fn.launches for k, fn in counters.items()}
        cfg = dryrun.at_depth(ARCHS[arch], rec["max_depth"])
        if shape.startswith("train"):
            want = {k: v * rec["micro_batches"]
                    for k, v in _family_counts(cfg).items()}
        else:
            kind = "varlen" if shape.startswith("prefill") else "paged"
            want = dict.fromkeys(counters, 0)
            want[kind] = cfg.num_layers
        if got != want:
            raise AssertionError(f"planner {arch} {shape}: launches {got}, "
                                 f"expected {want}")
        if not m["finite"]:
            raise AssertionError(f"planner {arch} {shape}: not finite {m}")
        for k, n in got.items():
            totals[k] += n
        terms, _ = dryrun.cell_terms(cfg, SHAPES_BY_NAME[shape])
        log(f"[planner] measured {arch} {shape} at {rec['max_depth']} layers: "
            f"{m['ms']:.1f} ms (CUDA events, first call), launches {got}, "
            f"{time.perf_counter() - t0:.1f} s with init")
        _fit(f"cell {arch} {shape}", terms, m["peak_bytes"])
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_run = time.perf_counter()

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] {fn.__name__}{args or ''}: "
            f"{time.perf_counter() - t0:.1f} s")
        return out

    smi = timed(phase_env)
    kres = timed(phase_kernels)
    pres = timed(phase_paged_kernel)
    lres = timed(phase_lse_kernels)
    mres = timed(phase_mamba_kernel)
    bres = timed(phase_mamba_bwd_kernel)
    dres = timed(phase_dense_kernel)
    launches = timed(phase_engine)
    timed(phase_small_reference, "granite-3-2b")
    hybrid, _ = timed(phase_hybrid_engine)
    for k, n in timed(phase_max_geometry).items():
        (hybrid if k == "mamba" else launches)[k] += n
    timed(phase_small_reference, "zamba2-1.2b")
    train = timed(phase_train)
    mesh_fwd, mesh_bwd = timed(phase_mesh_train, train["step_ms"])
    serve = timed(phase_mesh_serve)
    launches["varlen"] += serve["varlen"]
    launches["paged"] += serve["paged"]
    launches["dense"] += serve["dense"]
    fam = timed(phase_train_families)
    for phase in (phase_danube, phase_internlm2, phase_qwen, phase_moe_vlm,
                  phase_encdec_rwkv, phase_spec_fleet):
        for k, n in timed(phase).items():
            launches[k] += n
    plan = timed(phase_planner)
    launches["varlen"] += plan["varlen"]
    launches["paged"] += plan["paged"]
    for k in ("scan_fwd", "scan_bwd", "dense_fwd", "dense_bwd"):
        fam[k] += plan[k]
    log(f"[planner] {len(FITS)} predicted peaks within {FIT_TOL} of the "
        f"measured: largest error "
        f"{max(abs(p / m - 1) for _, p, m in FITS):.3f}")
    log(f"[time] whole run {time.perf_counter() - t_run:.1f} s")
    mixed, decode, dense = kres[0], pres[0], dres[0]
    dense_src = "src/repro_torch/kernels/flash_attention/csrc/dense_flash.cu"
    dense_tpu = "src/repro/kernels/flash_attention/kernel.py:21"
    record = {"kernels": [{
        "name": "varlen_flash",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "varlen_flash.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:64",
        "launches": launches["varlen"],
        "max_abs_err": max(r["err"] for r in kres + [
            x for x in lres if x["kernel"] == "varlen"]),
        "ms": mixed["ms"],
        "plain_ms": mixed["plain_ms"],
        "bound_ms": mixed["bound_ms"],
        "bound_by": mixed["bound_by"],
        "library_ms": mixed["library_ms"],
    }, {
        "name": "paged_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_decode.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:29",
        "launches": launches["paged"],
        "max_abs_err": max(r["err"] for r in pres + [
            x for x in lres if x["kernel"] == "paged"]),
        "ms": decode["ms"],
        "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"],
        "library_ms": None,
    }, {
        "name": "mamba_chunk_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:19",
        "launches": hybrid["mamba"] + fam["scan_fwd"] + serve["scan"],
        "max_abs_err": max(r["err"] for r in mres),
        "ms": mres[0]["ms"],
        "plain_ms": mres[0]["plain_ms"],
        "bound_ms": mres[0]["bound_ms"],
        "bound_by": mres[0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "mamba_chunk_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                  "mamba_scan_bwd.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:19",
        "launches": fam["scan_bwd"],
        "max_abs_err": max(r["err"] for r in bres),
        "ms": bres[0]["ms"],
        "plain_ms": bres[0]["plain_ms"],
        "bound_ms": bres[0]["bound_ms"],
        "bound_by": bres[0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "dense_flash_fwd",
        "route": "cuda",
        "source": dense_src,
        "replaces": dense_tpu,
        "launches": train["fwd_launches"] + mesh_fwd + launches["dense"] +
        fam["dense_fwd"],
        "max_abs_err": max(r["err"] for r in dres),
        "ms": dense["ms"],
        "plain_ms": dense["plain_ms"],
        "bound_ms": dense["bound_ms"],
        "bound_by": dense["bound_by"],
        "library_ms": dense["library_ms"],
    }, {
        "name": "dense_flash_bwd",
        "route": "cuda",
        "source": dense_src,
        "replaces": dense_tpu,
        "launches": train["bwd_launches"] + mesh_bwd + fam["dense_bwd"],
        "max_abs_err": max(r["grad_err"] for r in dres),
        "ms": dense["bwd_ms"],
        "plain_ms": dense["plain_bwd_ms"],
        "bound_ms": dense["bwd_bound_ms"],
        "bound_by": dense["bwd_bound_by"],
        "library_ms": dense["library_bwd_ms"],
    }]}
    log(f"card: {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
