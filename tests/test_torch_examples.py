"""The port's example twins (``examples/torch/``) and its CI job
(``.github/workflows/ci_torch.yml``): each twin runs in a subprocess on
the CPU at its CI size and must exit 0 and print what its reference
asserts; none of them, and no step of the job, reaches the JAX
package."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TWINS = os.path.join(ROOT, "examples", "torch")
CI = os.path.join(ROOT, ".github", "workflows", "ci_torch.yml")

# script, arguments (CI size), the line its reference's assert stands for
CASES = {
    "sedov_amr": (["--insitu"], "merged slice matches post-hoc assembly: "
                                "True", 2),
    "quickstart": ([], "resumed-vs-uninterrupted bitwise identical: True", 1),
    "train_llm": (["--tiny"], "losses fell", 1),
    "fault_tolerant_training": ([], "tensors identical after crash+restart. "
                                    "OK", 1),
    "serve_llm": ([], "every family served", 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_runs_on_the_cpu(name, tmp_path):
    args, line, count = CASES[name]
    # its own temp dir (the twins' paths sit in it), two threads a run
    env = {**os.environ, "PYTHONPATH": SRC, "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, os.path.join(TWINS, name + ".py"), *args,
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count(line) == count, proc.stdout[-3000:]


def test_twins_and_ci_job_use_only_the_port():
    names = sorted(f for f in os.listdir(TWINS) if f.endswith(".py"))
    assert names == sorted(n + ".py" for n in CASES)
    texts = {n: open(os.path.join(TWINS, n)).read() for n in names}
    texts["ci_torch.yml"] = open(CI).read()
    for name, text in texts.items():
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), name
        assert not re.search(r"\brepro\b(?!_torch)", text), name
    ci = texts["ci_torch.yml"]
    assert "tests/test_torch_*.py" in ci
    assert "--timeout=120 --timeout-method=thread" in ci
    for n in names:
        assert f"examples/torch/{n}" in ci
    for entry in ("insitu", "obs", "catalog_serve", "train"):
        assert f"python -m repro_torch.launch.{entry}" in ci
