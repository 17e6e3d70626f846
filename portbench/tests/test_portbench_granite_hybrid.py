"""The granite-4.0-h-small cell: its model FLOPs by hand, its entries in
BENCHMARK.json, and its small size for the CPU runs of the other tests.

The other files' cases run every cell of BENCHMARK.json at a small size
(``conftest.small_root``), which needs each configuration's small widths
and each cell's limits there: this module gives the granite hybrid's to
``conftest.SMALL`` and ``SMALL_LIMITS`` when pytest collects it, so run
the directory as a whole (``python -m pytest portbench/tests``). Any
other file of the directory run alone (``python -m pytest
portbench/tests/test_portbench_runs.py``) fails with a KeyError in
``small_root``: BENCHMARK.json names the granite hybrid and
``conftest.SMALL`` has no entry for it until this module is imported."""
import json

import conftest
from conftest import ROOT

from portbench import harness

CONFIG, CELL = "granite-4.0-h-small", "granite-4.0-h-small.train-insitu"
#: the port's SMOKE widths of the family: 5 layers (4 Mamba-2, 1
#: attention), 16 experts with 4 held (a quarter, as 9 of 72 is an
#: eighth), top-4, a shared expert, chunks of 8
conftest.SMALL[CONFIG] = dict(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, n_experts=16, top_k=4, experts_held=4, moe_groups=2,
    shared_ff=48, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    attention_multiplier=0.0625,
    block_pattern=["ssm_moe", "ssm_moe", "moe", "ssm_moe", "ssm_moe"])
#: limits at the small size, from 12 seeds (100-111) on the CPU against
#: the float8 control's seeds 1-3. Largest sound reading / smallest
#: control reading: loss 2.1e-4 / 3.5e-4, grad 1.2e-1 / 1.1e-1, change
#: 1.1e-2 / 1.5e-2, stats 1.5e-1 / 1.3e-1, final stats 1.2e-7 / 9.9e-8.
#: At 64 tokens a router's bf16 rounding moves a token to another of
#: the 16 experts, and where one of the 4 held experts gains or loses it
#: the router's gradient moves by up to 12 %: the gradient and the
#: stats cannot tell the control apart here, so each of those limits is
#: twice the largest sound reading, and the loss and the change, which
#: can, each lie between the two (the limits of the card's size are set
#: on the card, PERF.md)
conftest.SMALL_LIMITS[CELL] = dict(
    loss_gap=2.7e-4, grad_gap=0.25, change_gap=1.3e-2, tnorm_gap=0.3,
    tnorm_final_gap=1e-6, outputs_missing=0)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
REF = harness.load_module(ROOT / "portbench/reference/granite_hybrid_lm.py")


def test_flops_of_the_cell():
    doc = json.loads((ROOT / "portbench/configs/granite-4.0-h-small.json")
                     .read_text())
    m = doc["model"]
    # per token, forward: 9 Mamba-2 layers' projections, 4096 x (2 x 8192
    # + 2 x 128 + 128) in and 8192 x 4096 out; the attention layer's q,
    # k, v, o, 4096 x 128 x (32 + 16) + 32 x 128 x 4096; every layer's
    # router 4096 x 72 and shared expert 3 x 4096 x 1536; the held
    # experts at 10 x 9 / 72 = 1.25 assignments a token, 3 x 4096 x 768
    # each; the tied head 4096 x 100352
    ssm = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 4096 * 128 * (32 + 16) + 32 * 128 * 4096
    n = 9 * ssm + attn + 10 * (4096 * 72 + 3 * 4096 * 1536) \
        + 10 * 3 * 4096 * 768 * 10 * 9 // 72 + 4096 * 100352
    assert n == 1_682_767_872
    assert REF.matmul_params_per_token(m) == n
    # 6 x that; the attention layer's scores and values over the whole
    # sequence, 12 x 32 x 128 x 4096; each Mamba-2 layer's SSD products
    # at chunk 256, state 128, 128 heads of 64 (within-chunk C B^T and
    # its product with x dt, the chunk state and its output), 3 x
    # (2 x 128 x 256 + 2 x 128 x 64 x 256 + 4 x 128 x 64 x 128)
    ssd = 3 * (2 * 128 * 256 + 2 * 128 * 64 * 256 + 4 * 128 * 64 * 128)
    want = 6 * n + 12 * 32 * 128 * 4096 + 9 * ssd
    assert REF.train_flops_per_token(m, 4096) == want == 10_526_195_712


def test_the_benchmark_takes_the_new_entries():
    """BENCHMARK.json with the cell validates; the cell reports
    ``train_tokens_per_s``, ``setup_s`` and, traced, the per-layer
    metrics of its mechanism; its configuration file states the catalog's
    keys, the two cut and listed in ``reduced``."""
    bench = harness.validate(BENCH)
    assert {m["name"] for m in harness.metrics_of(bench, CELL, False)} == \
        {"train_tokens_per_s", "setup_s"}
    traced = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
    assert {"mfu", "device.peak_gb", "block.ssm_ms", "block.ffn_ms",
            "block.attention_ms", "moe.held_share", "moe.drop_share",
            "attn.kernel_share"} <= traced
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    doc = json.loads((ROOT / entry["file"]).read_text())
    assert doc["reduced"] == entry["reduced"] == ["num_hidden_layers",
                                                  "num_local_experts"]
    assert (doc["num_hidden_layers"], doc["num_local_experts"]) == (10, 9)
    assert doc["published"] == {"num_hidden_layers": 40,
                                "num_local_experts": 72}
    m = doc["model"]
    assert (m["n_layers"], m["experts_held"], m["n_experts"]) == (10, 9, 72)
    assert (m["d_model"], m["d_ff"], m["shared_ff"], m["top_k"]) == \
        (doc["hidden_size"], doc["intermediate_size"],
         doc["shared_intermediate_size"], doc["num_experts_per_tok"])


def test_held_share_reader():
    reader = harness.load_module(ROOT / "portbench/metrics/moe.held_share.py")
    spans = [{"name": "train.step", "args": {"moe_routed": 800,
                                             "moe_held": 100}},
             {"name": "train.step", "args": {"moe_routed": 800,
                                             "moe_held": 120}},
             {"name": "block.ffn", "args": {"device_ms": 1.0}}]
    assert reader.read({"spans": spans}) == 100.0 * 220 / 1600
    assert reader.read({"spans": spans[2:]}) is None
    ssm = harness.load_module(ROOT / "portbench/metrics/block.ssm_ms.py")
    assert ssm.read({"spans": [{"name": "block.ssm",
                                "args": {"device_ms": 3.0}},
                               {"name": "block.ssm",
                                "args": {"device_ms": 5.0}}]}) == 4.0
    assert ssm.read({"spans": spans}) is None
