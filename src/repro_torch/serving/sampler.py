"""Token selection, on the host and on the device (``repro/serving/sampler.py``).

Greedy resolves within a tie band: any token whose fp32 logit is within
``TIE_EPS`` of the row max is tie-eligible and the lowest id wins. On the
device that is ``argmax(x >= max - eps)`` — argmax returns the first
maximal index, the lowest id in the band — bit-identical to the host
``np.flatnonzero`` form, since max and compare are exact fp32 operations
on the same values.

The token board: the fused dispatch tail scatters each segment's token into
a persistent device int32 board at a per-request slot; a later dispatch
whose input token is still in flight reads it back on the device
(``inject_tokens``). Host arrays use -1 for "no write"/"no read". The
board's last element is a trash slot that -1 writes are redirected to: a
negative index would wrap in torch and an out-of-range one faults on CUDA.

Seeded temperature/top-k: ``logits / T`` -> fp32 log-softmax -> top-k
truncation (k-th largest score as the threshold; ``top_k <= 0`` keeps
everything) -> Gumbel-max draw picked through the same tie band. The key
of a row is ``(seed, rid_hash, position)``, never the batch shape or slot,
so every layout and both samplers draw the same token. The card's machine
has no JAX, so the reference's threefry2x32 key derivation and ``(V,)``
uniform draws are written out here in torch integer ops (int64 tensors
masked to 32 bits: torch has no uint32 shifts); their bits equal
``jax.random``'s (``jax_threefry_partitionable``, the default). The
log-softmax and logs are torch's, so scores differ from XLA's by ulps and
a draw can differ only where two candidates sit at the band edge.
"""
import zlib

import numpy as np
import torch

# Greedy tie band over fp32 logits; see module docstring.
TIE_EPS = 5e-3
# Matches the pad-vocab mask value in models.tp.mask_pad_vocab.
NEG = -1e30

_M32 = 0xFFFFFFFF
# threefry2x32's rotations (two alternating groups of four rounds) and its
# key-schedule parity constant, as in jax/_src/prng.py
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# uniform's open interval: u == 1.0 would give -log(-log(u)) == +inf
_U_MIN, _U_MAX = 1e-7, 1.0 - 1e-7


def greedy_token(logits) -> int:
    """Host greedy pick: lowest token id within TIE_EPS of the row max."""
    # jengalint: allow[host-sync] fetch phase: row was already fetched by runner.fetch
    logits = np.asarray(logits, np.float32)
    return int(np.flatnonzero(logits >= logits.max() - TIE_EPS)[0])


def rid_hash(rid: str) -> int:
    """Stable 32-bit request-id hash (Python ``hash`` is process-salted)."""
    return zlib.crc32(rid.encode()) & 0xFFFFFFFF


# --------------------------------------------------------------- threefry
def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2): int64 tensors holding uint32 values, broadcast
    together. Returns the two output words."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x = [(x1 + k1) & _M32, (x2 + k2) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = ((x[1] << r) & _M32) | (x[1] >> (32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seed: torch.Tensor):
    """``jax.random.PRNGKey`` of int32 seeds: the key (0, seed as uint32)."""
    return torch.zeros_like(seed, dtype=torch.int64), \
        seed.to(torch.int64) & _M32


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in``: the hash of the counter pair (0, data as
    uint32) under ``key``."""
    k1, k2 = key
    return threefry2x32(k1, k2, torch.zeros_like(k1),
                        data.to(torch.int64) & _M32)


def derive_key(seeds, rhs, poss):
    """Per-row key of (seed, rid_hash, position): PRNGKey(seed) folded with
    the rid hash, then with the position (the reference's ``_derive_key``)."""
    return fold_in(fold_in(prng_key(seeds), rhs), poss)


def random_bits(key, v: int) -> torch.Tensor:
    """(rows, v) 32-bit random words of each row's key (int64): the hash of
    the counters (0, i), i < v, its two words XORed (the partitionable
    threefry of ``jax.random.bits``)."""
    k1, k2 = (k[:, None] for k in key)
    cnt = torch.arange(v, dtype=torch.int64, device=k1.device)[None]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(cnt), cnt)
    return b1 ^ b2


def uniform(key, v: int) -> torch.Tensor:
    """``jax.random.uniform(key, (v,), float32, 1e-7, 1 - 1e-7)`` per row:
    the 23 high bits as a mantissa under the exponent of 1.0, minus 1,
    scaled into the interval and clamped below by its lower end. XLA fuses
    the scale and shift into one fused multiply-add; the float64 form
    below is exact (f, a multiple of 2^-23, times a 24-bit scale plus the
    lower end, all multiples of 2^-47 under 1) and rounds once, as the
    fused form does."""
    bits = (random_bits(key, v) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_U_MIN, dtype=torch.float32, device=f.device)
    hi = torch.tensor(_U_MAX, dtype=torch.float32, device=f.device)
    u = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, u)


# ------------------------------------------------------ temperature / top-k
def perturbed_scores(x, temps, top_ks, key):
    """Rows of fp32 log-softmax of ``x / max(T, 1e-6)``, top-k truncated
    (``top_k <= 0`` keeps all) and Gumbel-perturbed: their band pick is a
    draw from the truncated softmax. ``x`` (rows, V) fp32 over the FULL
    padded vocab row (pad columns at NEG never win); temps (rows,) fp32,
    top_ks (rows,) int32, ``key`` per row."""
    s = x / torch.clamp(temps, min=1e-6)[:, None]
    z = torch.log_softmax(s, dim=-1)
    v = s.shape[-1]
    srt = torch.sort(s, dim=-1, descending=True).values
    kth = srt.gather(1, (top_ks.long() - 1).clamp(0, v - 1)[:, None])
    keep = (top_ks <= 0)[:, None] | (s >= kth)
    z = torch.where(keep, z, torch.full((), NEG, device=z.device))
    u = uniform(key, v)
    return z - torch.log(-torch.log(u))


def host_sample(row, temperature, top_k, rh, pos, seed, device) -> int:
    """Temperature/top-k draw for one FULL-WIDTH (v_pad) logits row, run
    through the dispatch tail's own torch functions on ``device`` (the
    engine's): the card's log/exp differ from the CPU's by ulps, which can
    move a band edge, so the host path must draw where the fused tail
    does."""
    # jengalint: allow[host-sync] fetch phase: the row was already fetched by runner.fetch
    x = torch.as_tensor(np.asarray(row, np.float32))[None].to(device)
    i32 = dict(dtype=torch.int32, device=device)
    key = derive_key(torch.tensor([seed], **i32),
                     torch.tensor([rh], dtype=torch.int64, device=device),
                     torch.tensor([pos], **i32))
    g = perturbed_scores(x, torch.tensor([temperature], dtype=torch.float32,
                                         device=device),
                         torch.tensor([top_k], **i32), key)
    return int(band_pick(g)[0])


def band_pick(x: torch.Tensor) -> torch.Tensor:
    """Lowest index within TIE_EPS of the row max (trailing axis), int32."""
    m = x.amax(dim=-1, keepdim=True)
    return torch.argmax((x >= m - TIE_EPS).to(torch.uint8),
                        dim=-1).to(torch.int32)


def sample_batch(logits: torch.Tensor, board: torch.Tensor,
                 dst: torch.Tensor, samp=None) -> torch.Tensor:
    """Fused dispatch tail: pick each row's token and scatter it into
    ``board`` (in place) at ``dst``; dst -1 writes nowhere (to the trash
    slot). Greedy rows take the band pick of the logits; with ``samp``
    (temps, top_ks, rhs, poss, seeds: per-row device tensors, given only
    when some row has temperature > 0) rows with T > 0 take the seeded
    draw. Returns the (rows,) int32 tokens."""
    x = logits.float()
    toks = band_pick(x)
    if samp is not None:
        temps, top_ks, rhs, poss, seeds = samp
        g = perturbed_scores(x, temps, top_ks, derive_key(seeds, rhs, poss))
        toks = torch.where(temps > 0, band_pick(g), toks)
    trash = board.shape[0] - 1
    idx = torch.where(dst < 0, trash, dst).long()
    board.index_copy_(0, idx, toks)
    return toks


def inject_tokens(tokens: torch.Tensor, src: torch.Tensor,
                  board: torch.Tensor) -> torch.Tensor:
    """Replace tokens at positions where ``src >= 0`` with board[src]."""
    fed = board[src.clamp(0, board.shape[0] - 2).long()]
    return torch.where(src >= 0, fed.to(tokens.dtype), tokens)
