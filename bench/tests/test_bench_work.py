"""The work counts against hand-worked cases."""
import pytest

from bench import work
from bench.peaks import bound_seconds

TOY = {"family": "dense", "num_layers": 2, "attn_pattern": ["full", "swa"],
       "sliding_window": 4, "num_heads": 2, "num_kv_heads": 1,
       "head_dim": 8, "d_model": 16, "d_ff": 32, "vocab_size": 10}
HYB = {"family": "hybrid", "num_layers": 3, "attn_every": 2, "d_model": 8,
       "mamba_expand": 2, "mamba_headdim": 4, "mamba_d_state": 3,
       "num_heads": 2, "num_kv_heads": 2, "head_dim": 4, "d_ff": 16,
       "vocab_size": 10}


def test_pairs_and_keys_by_hand():
    # a chunk of 3 at positions 5, 6, 7: full sees 6 + 7 + 8 keys
    assert work.visible_pairs(5, 3) == 21
    assert work.distinct_keys(5, 3) == 8
    # window 4: each sees 4 keys; keys 2..7 are read
    assert work.visible_pairs(5, 3, 4) == 12
    assert work.distinct_keys(5, 3, 4) == 6
    # a chunk at 1, 2, 3, 4 under window 4: 2 + 3 + 4 + 4
    assert work.visible_pairs(1, 4, 4) == 13
    assert work.distinct_keys(1, 4, 4) == 5


def test_varlen_by_hand():
    # one decode at position 5 (full: 6 keys; window 4: 4 keys)
    flops, nbytes = work.varlen([(5, 1, 5)], TOY)
    assert flops == 4 * 2 * 8 * (6 + 4)
    q_o = 2 * 1 * 2 * 8 * 2
    assert nbytes == 2 * q_o + 2 * (6 + 4) * 1 * 8 * 2


def test_scan_by_hand():
    # two rows (4 tokens and 1 token): H 4, P 4, N 3, 3 layers
    flops, nbytes = work.scan([(10, 4, 0), (3, 1, 7)], HYB)
    assert flops == 3 * 5 * 4 * 4 * 3 * 5
    per_tok = 4 * 4 * 2 + 2 * 3 * 2 + 4 * 4 + 4 * 4 * 4
    assert nbytes == 3 * (5 * per_tok + 2 * (2 * 4 * 4 * 3 * 4) + 4 * 4)
    assert work.scan([(10, 4, 0)], TOY) == (0.0, 0.0)


def test_model_flops_by_hand():
    # dense layer: q, o 16x16 each, k, v 16x8 each, MLP 3 x 16x32
    per_layer = 16 * 16 * 2 + 16 * 8 * 2 + 3 * 16 * 32
    assert work.matmul_params(TOY) == 2 * per_layer
    # a prompt's last chunk (samples) and a mid-prompt chunk (does not)
    items = [(8, 3, 5), (20, 4, 0)]
    att = work.varlen(items, TOY)[0]
    assert work.model_flops(items, TOY) == pytest.approx(
        2 * 2 * per_layer * 7 + 2 * 16 * 10 * 1 + att)


def test_bound_takes_the_larger_term():
    assert bound_seconds(989e12, 0) == pytest.approx(1.0)
    assert bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert bound_seconds(989e12, 6.7e12) == pytest.approx(2.0)
