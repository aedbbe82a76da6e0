"""Each example under ``examples/torch`` runs short on the CPU (reduced
configs, a few steps) and tells its story; without ``--device cpu`` it asks
for the card and raises here."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "examples" / "torch"))

import quickstart  # noqa: E402
import serve_heterogeneous  # noqa: E402
import spec_decode_demo  # noqa: E402
import train_hybrid  # noqa: E402


def test_quickstart_trains_then_serves(tmp_path):
    hist, done = quickstart.main(["--device", "cpu", "--steps", "3",
                                  "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 3 and np.isfinite(hist).all()
    assert sorted(r.rid for r in done) == ["req0", "req1", "req2"]
    assert all(len(r.output) == 8 for r in done)


def test_train_hybrid_restores_its_last_checkpoint(tmp_path):
    hist, last, params = train_hybrid.main(
        ["--device", "cpu", "--steps", "2", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert last == 2 and "mamba_main" in params


def test_serve_heterogeneous_baseline_holds_more():
    peaks = serve_heterogeneous.main(["--device", "cpu", "--new-tokens",
                                      "2"])
    assert set(peaks) == set(serve_heterogeneous.ARCHES)
    assert all(p >= j > 0 for j, p in peaks.values()), peaks
    jenga, paged = peaks["h2o-danube-3-4b"]
    assert paged > jenga, peaks      # window pages never retire


def test_spec_decode_demo_shares_one_pool():
    sizes, out = spec_decode_demo.main(["--device", "cpu", "--new-tokens",
                                        "4"])
    assert sizes == {"tgt_full_attn": 1024, "draft_full_attn": 512}
    assert len(out) == 4


def test_examples_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
