"""The harness finds every file by name, keeps the rules of its files,
imports neither JAX nor the JAX package, and counts model FLOPs by hand."""
import ast
import copy
import json
import math
from pathlib import Path

import pytest
import torch
from conftest import ROOT

from portbench import harness, yardstick

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    job, runner = harness.make_job(ROOT, harness.validate(BENCH), workload,
                                   1, 1.0, False, torch.device("cpu"))
    assert job.config["name"] == job.workload["config"]
    assert callable(runner.run) and callable(job.reference.train)
    assert set(job.cell["limits"]) >= {"loss_gap", "outputs_missing"}
    for trace in (False, True):
        for m in harness.metrics_of(BENCH, workload, trace):
            reader = harness.load_module(
                ROOT / "portbench" / "metrics" / f"{m['name']}.py")
            assert reader.read({}) is None      # nothing to read: nothing


def test_each_cell_reports_setup_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(BENCH, w["name"], True)


def _broken(path, value):
    doc = copy.deepcopy(BENCH)
    node = doc
    for k in path[:-1]:
        node = node[k]
    if value is KeyError:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return doc


@pytest.mark.parametrize("path,value", [
    (("workloads", 0, "why"), KeyError),
    (("end_to_end", 0, "bound"), KeyError),
    (("per_layer", 0, "moves"), KeyError),
    (("configs", 0, "reduced"), KeyError),
    (("workloads", 0, "name"), "two words"),
    (("workloads", 0, "name"), "a/b"),
    (("workloads", 0, "name"), ".hidden"),
    (("per_layer", 0, "name"), "x" * 65),
    (("per_layer", 0, "unit"), "tokens per second"),
    (("per_layer", 0, "unit"), "µs"),
    (("end_to_end", 0, "better"), "more"),
    (("per_layer", 0, "source"), "guess"),
    (("per_layer", 0, "moves"), "nothing_like_it"),
    (("workloads", 0, "config"), "no-such-config"),
    (("per_layer", 0, "extra"), "key"),
    (("command",), KeyError),
])
def test_refuses_a_broken_benchmark_file(path, value):
    with pytest.raises(harness.BenchError):
        harness.validate(_broken(path, value))


@pytest.mark.parametrize("kind,name", [("cell", "limits"),
                                       ("config", "model"),
                                       ("config", "reference"),
                                       ("traffic", "runner")])
def test_refuses_a_file_without_a_key(tmp_path, kind, name):
    src = {"cell": ROOT / "portbench/cells" /
           f"{BENCH['workloads'][0]['name']}.json",
           "config": ROOT / BENCH["configs"][0]["file"],
           "traffic": ROOT / "portbench/traffic" /
           f"{BENCH['workloads'][0]['traffic']}.json"}[kind]
    doc = json.loads(src.read_text())
    del doc[name]
    path = tmp_path / "f.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(harness.BenchError):
        harness.load_json(path, kind)
    harness.load_json(src, kind)


#: mixes a later cell could bring as a data file alone, each an edit of
#: ``train-insitu``: a shorter sequence; the engine off (no ``insitu``
#: table); a second reducer, whose output checker is a new
#: ``outputs/<class>.py``
NEW_MIXES = {
    "train-short": lambda mix: mix.update(seq_len=16),
    "train-plain": lambda mix: mix.pop("insitu"),
    "train-two-reducers":
        lambda mix: mix["insitu"]["reducers"].append("SliceNormReducer"),
}
#: a reducer for the two-reducer mix: the port's norm reducer under
#: another name, put where the runner looks reducers up
SLICE_NORM = """
from repro_torch.insitu import TensorNormReducer
class SliceNormReducer(TensorNormReducer):
    def __post_init__(self):
        super().__post_init__()
        self.name = "snorm"
"""


@pytest.mark.parametrize("mix", sorted(NEW_MIXES))
def test_a_new_cell_is_new_files_and_entries_only(small, mix, monkeypatch):
    """A configuration, a mix, a cell and a metric added as new files
    and BENCHMARK.json entries run, and no file that was there changes."""
    before = {p: p.read_bytes() for p in (small / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads((small / "BENCHMARK.json").read_text())
    pb = small / "portbench"
    cfg = json.loads((small / bench["configs"][0]["file"]).read_text())
    cfg["name"] = cfg["model"]["name"] = "tiny-dense"
    cfg["model"]["n_layers"] = 1
    (pb / "configs/tiny-dense.json").write_text(json.dumps(cfg))
    doc = json.loads((pb / "traffic/train-insitu.json").read_text())
    NEW_MIXES[mix](doc)
    (pb / f"traffic/{mix}.json").write_text(json.dumps(doc))
    limits = json.loads((pb / "cells" / f"{bench['workloads'][0]['name']}"
                         ".json").read_text())["limits"]
    if "insitu" not in doc:
        limits = {k: v for k, v in limits.items()
                  if k in ("loss_gap", "grad_gap", "change_gap")}
    if mix == "train-two-reducers":
        import repro_torch.insitu
        ns: dict = {}
        exec(SLICE_NORM, ns)
        monkeypatch.setattr(repro_torch.insitu, "SliceNormReducer",
                            ns["SliceNormReducer"], raising=False)
        (pb / "outputs/SliceNormReducer.py").write_bytes(
            (pb / "outputs/TensorNormReducer.py").read_bytes())
        limits.update(snorm_gap=limits["tnorm_gap"],
                      snorm_final_gap=limits["tnorm_final_gap"])
    (pb / f"cells/tiny-dense.{mix}.json").write_text(
        json.dumps({"limits": limits}))
    (pb / "metrics/window_steps.py").write_text(
        "def read(ctx):\n    return len(ctx.get('window_ends', ())) or None\n")
    name = f"tiny-dense.{mix}"
    bench["configs"].append({**bench["configs"][0], "name": "tiny-dense",
                             "file": "portbench/configs/tiny-dense.json"})
    bench["workloads"].append({"name": name, "config": "tiny-dense",
                               "traffic": mix, "chips": 1,
                               "why": "a cell added by files alone"})
    bench["per_layer"].append({"name": "window_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step",
                               "moves": "train_tokens_per_s",
                               "workloads": [name]})
    engine = ("insitu.", "hdep.")           # what only the engine reports
    for m in bench["end_to_end"] + bench["per_layer"][:-1]:
        if "workloads" in m and ("insitu" in doc or
                                 not m["name"].startswith(engine)):
            m["workloads"].append(name)
    (small / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell(small, name, 5, 3.0, True, torch.device("cpu"),
                           0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["window_steps"]["value"] >= 1
    assert set(out["checks"]) == set(limits)
    # the engine's spans are read where the engine runs
    assert ("insitu.submit_ms" in out["metrics"]) == ("insitu" in doc)
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & set(harness.FORBIDDEN)
        assert not bad, (f, bad)      # top-level names compared whole


def test_the_reference_imports_nothing_of_the_port():
    for d in ("reference", "outputs"):
        for f in (ROOT / "portbench" / d).glob("*.py"):
            assert _imports(f) <= {"__future__", "math", "torch",
                                   "portbench"}, f
    assert _imports(ROOT / "portbench" / "yardstick.py") <= {
        "__future__", "bisect", "itertools", "math", "numpy"}


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    import sys
    assert "repro_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]


REF = harness.load_module(ROOT / "portbench/reference/decoder_lm.py")


def test_flops_by_hand_for_the_smoke_configs():
    from repro_torch.configs import get_smoke_config
    import dataclasses
    s = dataclasses.asdict(get_smoke_config("stablelm_1_6b"))
    # 2 layers x (4 x 64 x 64 attention + 3 x 64 x 128 MLP) + 64 x 256
    assert REF.matmul_params_per_token(s) == \
        2 * (16384 + 24576) + 16384 == 98304
    assert REF.train_flops_per_token(s, 32) == \
        6 * 98304 + 12 * 2 * 64 * 32
    g = dataclasses.asdict(get_smoke_config("granite_moe_1b_a400m"))
    # attention: q 64x4x16 and o 4x16x64 (4,096 each), k and v 64x2x16
    # (2,048 each) = 12,288; top 4 of 8 experts x 3 x 64 x 32 = 24,576;
    # router 64 x 8 = 512; tied unembedding 64 x 256
    assert REF.matmul_params_per_token(g) == \
        2 * (12288 + 24576 + 512) + 16384 == 91136
    assert REF.train_flops_per_token(g, 32) == \
        6 * 91136 + 12 * 2 * 4 * 16 * 32
    # a family the reference does not cover has no count: an error, not
    # a metric left out
    with pytest.raises(ValueError):
        REF.train_flops_per_token(dict(s, family="ssm"), 32)


def test_flops_of_the_cells():
    got = {}
    for c in BENCH["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        ref = harness.load_module(ROOT / "portbench/reference" /
                                  f"{doc['reference']}.py")
        got[c["name"]] = ref.train_flops_per_token(doc["model"], 4096)
    # stablelm: 24 x (4 x 2048^2 + 3 x 2048 x 5632) + 2048 x 100352
    n = 24 * (4 * 2048 ** 2 + 3 * 2048 * 5632) + 2048 * 100352
    assert got["stablelm-1.6b"] == 6 * n + 12 * 24 * 2048 * 4096
    # granite: 24 x (3,145,728 attention + 8 x 1,572,864 + 32,768)
    # + 1024 x 49155 tied
    n = 24 * (3145728 + 8 * 1572864 + 32768) + 1024 * 49155
    assert got["granite-moe-1b-a400m"] == 6 * n + 12 * 24 * 1024 * 4096


def test_trace_arithmetic():
    iv = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert yardstick.union_length(iv, 0, 10) == 6
    assert yardstick.idle_gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    host = yardstick.HostOps([(2, 4.5, "aten::item", 1), (4.6, 9, "x", 1),
                              (0, 1, "early", 1), (3.5, 5, "lane", 2)])
    assert host.during((3, 5)) == "aten::item"
    assert host.during((4.55, 6)) == "x"
    assert host.during((1.2, 1.9)) == "python"
    assert yardstick.HostOps([]).during((3, 5)) == "python"
    assert yardstick.top_by_name([("a", 1.0), ("b", 3.0), ("a", 2.5)]) == \
        [["a", 3.5], ["b", 3.0]]


def test_gaps():
    assert yardstick.rel_gap([2.0, 4.0], [2.0, 5.0]) == pytest.approx(0.2)
    assert yardstick.rel_gap([math.nan], [1.0]) == math.inf
    ref = {"a": 1.0, "b": 2.0, "c": 10.0}
    assert yardstick.gap_of_norms({"a": 1.0, "b": 2.0, "c": 10.0}, ref) == 0
    # a small leaf's gap is taken against the median leaf's norm
    assert yardstick.gap_of_norms({"a": 1.2, "b": 2.0, "c": 10.0},
                                  ref) == pytest.approx(0.1)
    assert yardstick.gap_of_norms({"a": 0.0, "b": 2.0, "c": 10.0}, ref,
                                  keep={"b", "c"}) == 0
    assert yardstick.gap_of_norms({"b": 2.0, "c": 10.0}, ref) == math.inf
    st = {"w": [2.0, 1.0, 3.0, 0.5]}
    assert yardstick.stats_gap({"w": [2.0, 1.0, 3.0, 0.6]}, st) == \
        pytest.approx(0.1)
    assert yardstick.stats_gap({}, st) == math.inf


def test_token_stream_is_the_ports_and_a_function_of_the_seed():
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    seed = 3_000_000_017
    ours = yardstick.TokenStream(1000, 64, 4, seed, 1.1)
    port = TokenPipeline(DataConfig(vocab_size=1000, seq_len=64,
                                    global_batch=4, seed=seed))
    for step in (0, 7):
        a, b = ours.batch(step), port.batch(step)
        assert (a["tokens"] == b["tokens"]).all()
        assert (a["labels"] == b["labels"]).all()
    rows = ours.batch(0)["tokens"]
    assert len({r.tobytes() for r in rows}) == len(rows)   # rows differ
