"""Fault tolerance demo on the PyTorch + CUDA port (``repro_torch``),
twin of ``examples/fault_tolerant_training.py``: supervisor + induced
crash + elastic resume.

    PYTHONPATH=src python examples/torch/fault_tolerant_training.py [--device cpu]

1. Launch training (``python -m repro_torch.launch.train`` on
   ``--device``: the GPU unless ``cpu`` is asked for) under the
   supervisor with TRAIN_CRASH_AT=7: the child hard-exits mid-run
   (simulated node failure).
2. The supervisor relaunches; the new process restores the latest
   complete HProt context and finishes.
3. Verify the final state matches an uninterrupted run bit for bit.
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402

from repro_torch.hercule.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.insitu.device import resolve_device  # noqa: E402
from repro_torch.train.supervisor import run_supervised  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "..", "src")
CKPT = os.path.join(tempfile.gettempdir(), "hx_ft_demo_torch")


def train_cmd(ckpt_dir, device, steps=14):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "stablelm_1_6b", "--smoke", "--steps", str(steps),
            "--seq-len", "32", "--global-batch", "4",
            "--ckpt-every", "5", "--ckpt-dir", ckpt_dir,
            "--device", str(device)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' to train on the CPU")
    device = resolve_device(ap.parse_args().device)
    shutil.rmtree(CKPT, ignore_errors=True)
    shutil.rmtree(CKPT + "_ref", ignore_errors=True)
    env = {"PYTHONPATH": SRC}

    print(f"== supervised run on {device} with induced (one-off) crash at "
          f"step 7", flush=True)
    rc, restarts = run_supervised(train_cmd(CKPT, device), max_restarts=3,
                                  env=env, env_first={"TRAIN_CRASH_AT": "7"})
    print(f"   supervisor: rc={rc} restarts={restarts}")
    assert rc == 0 and restarts >= 1

    print("== uninterrupted reference run", flush=True)
    subprocess.run(train_cmd(CKPT + "_ref", device),
                   env={**os.environ, **env}, check=True)

    print("== compare final checkpoints bit for bit")
    a = CheckpointManager(CKPT)
    b = CheckpointManager(CKPT + "_ref")
    assert a.latest_step() == b.latest_step() == 14
    # indexed views: each manifest is parsed once for the whole comparison
    va = a.db.view(14)
    vb = b.db.view(14)
    keys = {(r.name, r.domain) for r in va.records}
    assert keys == {(r.name, r.domain) for r in vb.records}
    for rec in va.records:
        wa = va.read_record(rec)
        wb = vb.read(rec.domain, rec.name)
        assert np.array_equal(wa, wb), (rec.name, rec.domain)
    print(f"   {len(keys)} tensors identical after crash+restart. OK")


if __name__ == "__main__":
    main()
