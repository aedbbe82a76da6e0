"""The load generator: one seed gives one set of requests, other seeds the
same sizes in the same order and other token ids, inside each mix's
ranges."""
import collections

import pytest

from bench import manifest
from bench.loadgen import Traffic, stratified

MIXES = tuple(sorted(p.stem for p in (manifest.BENCH / "traffic").glob(
    "*.json")))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    spec = manifest.traffic(mix)
    a, b = Traffic(spec, 32000, 2**31 + 11), Traffic(spec, 32000, 2**31 + 11)
    for i in (0, 1, 63, 64, 200):
        assert a.request(i) == b.request(i)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_same_sizes_other_tokens(mix):
    """Every seed sends the same sizes in the same order, so every seed
    puts the same work into a window; the token ids differ."""
    spec = manifest.traffic(mix)
    a, b = Traffic(spec, 32000, 1), Traffic(spec, 32000, 2**31 + 3)
    n = 2 * spec["block"]
    sizes = [a.sizes(i) for i in range(n)]
    assert sizes == [b.sizes(i) for i in range(n)]
    # each block holds the mix's stratified lengths, in a shuffled order
    first = sizes[:spec["block"]]
    assert collections.Counter(p for p, _ in first) == \
        collections.Counter(a.prompt_lens)
    assert [p for p, _ in first] != sorted(p for p, _ in first)
    assert a.request(0)[0][:16] != b.request(0)[0][:16]


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_inside_the_ranges(mix):
    spec = manifest.traffic(mix)
    tr = Traffic(spec, 32000, 5)
    p, o = spec["prompt_tokens"], spec["output_tokens"]
    for i in range(3 * spec["block"]):
        prompt, out = tr.request(i)
        assert p["lo"] <= len(prompt) <= p["hi"]
        assert o["lo"] <= out <= o["hi"]
        assert 0 <= min(prompt) and max(prompt) < 32000


def test_docqa_shape():
    """Mean prompt ~6.65k tokens, ~79% past 4096, as the mix is defined."""
    lens = stratified(manifest.traffic("docqa10")["prompt_tokens"], 4096)
    assert 6500 < sum(lens) / len(lens) < 6800
    assert 0.77 < sum(x > 4096 for x in lens) / len(lens) < 0.81
