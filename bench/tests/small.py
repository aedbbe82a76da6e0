"""Small configurations and mixes for the benchmark's CPU tests: the same
files as the cells', at widths a test process can hold."""
import copy
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]


def small_config(name: str) -> dict:
    """The configuration file ``name`` cut to a few small layers, on a
    pool and budget a CPU run fills."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    m = cfg["model"]
    m.update(d_model=64, num_heads=4, head_dim=16, d_ff=128,
             vocab_size=256, tokens_per_page=4, num_layers=4, num_kv_heads=2)
    cfg["engine"].update(kv_pool_bytes=16 << 20, max_num_batched_tokens=48,
                         chunk_size=24, max_running=8)
    return cfg


def small_traffic(name: str) -> dict:
    tr = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    tr.update(clients=4, block=8,
              prompt_tokens={"dist": "loguniform", "lo": 12, "hi": 60},
              output_tokens={"dist": "uniform", "lo": 2, "hi": 5})
    return tr
