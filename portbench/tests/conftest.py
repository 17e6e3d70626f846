"""Shared set-up of portbench's CPU tests: a copy of the benchmark at a
size the CPU runs in seconds."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
# several test workers share the machine's cores
torch.set_num_threads(2)
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: small widths of the two configurations' families (the port's SMOKE
#: configs' sizes)
SMALL = {
    "stablelm-1.6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256),
    "granite-moe-1b-a400m": dict(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=32, vocab_size=256,
                                 n_experts=8, top_k=4, moe_groups=2),
}
#: 2 x 32 tokens; the window runs a few steps
SMALL_TRAFFIC = dict(global_batch=2, seq_len=32)
#: limits at the small size, each two to four times the largest reading
#: of 12 seeds (100-111) on the CPU (dense: loss 3.8e-4, grad 1.5e-3,
#: change 7.5e-4, stats 7.1e-3; MoE: 1.7e-3, 7.4e-3, 2.9e-3, 1.7e-2),
#: and the gradient's under the float8 control's smallest reading on
#: seeds 1-3 (8.1e-3 dense, 3.4e-2 MoE)
SMALL_LIMITS = {
    "stablelm-1.6b.train-insitu": dict(
        loss_gap=1e-3, grad_gap=4e-3, change_gap=3e-3, tnorm_gap=3e-2,
        tnorm_final_gap=1e-5, outputs_missing=0),
    "granite-moe-1b-a400m.train-insitu": dict(
        loss_gap=4e-3, grad_gap=1.5e-2, change_gap=1e-2, tnorm_gap=5e-2,
        tnorm_final_gap=1e-5, outputs_missing=0),
}


def small_root(dst: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ under ``dst`` with every
    configuration cut to ``SMALL`` and the mix to ``SMALL_TRAFFIC``."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dst / c["file"]
        doc = json.loads(path.read_text())
        doc["model"].update(SMALL[c["name"]])
        path.write_text(json.dumps(doc))
    for name, limits in SMALL_LIMITS.items():
        (dst / "portbench" / "cells" / f"{name}.json").write_text(
            json.dumps({"limits": limits}))
    for path in (dst / "portbench" / "traffic").glob("*.json"):
        doc = json.loads(path.read_text())
        doc.update(SMALL_TRAFFIC)
        path.write_text(json.dumps(doc))
    return dst


@pytest.fixture
def small(tmp_path):
    return small_root(tmp_path)
