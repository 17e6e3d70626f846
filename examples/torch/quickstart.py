"""Quickstart: train a small LM with Hercule HProt checkpointing, on the
PyTorch + CUDA port (``repro_torch``), twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Demonstrates the public API end to end: pick an assigned architecture's
reduced config, train on ``--device`` (the GPU unless ``cpu`` is asked
for; without a GPU it raises), checkpoint (contexts in NCF-aggregated
files), restart, and verify the resume is bit-exact.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.insitu.device import resolve_device  # noqa: E402
from repro_torch.models.transformer import LM, tree_leaves  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

CKPT = os.path.join(tempfile.gettempdir(), "hx_quickstart_torch")


def make_trainer(device):
    cfg = get_smoke_config("minicpm_2b")
    lm = LM(cfg, device=device)
    return Trainer(
        lm,
        opt_cfg=optim.OptConfig(lr=1e-3, warmup_steps=5, stable_steps=100,
                                decay_steps=20),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                            global_batch=8),
        ckpt_dir=CKPT, ckpt_every=10, ckpt_mode="auto", ncf=4, log_every=10,
        device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' to train on the CPU")
    device = resolve_device(ap.parse_args().device)
    shutil.rmtree(CKPT, ignore_errors=True)

    print(f"== phase 1: train 20 steps on {device} (checkpoints at 10, 20)")
    t1 = make_trainer(device)
    t1.run(20)

    print("== phase 2: new trainer resumes from context 20, trains to 40")
    t2 = make_trainer(device)
    state = t2.run(40)

    print("== phase 3: uninterrupted 40-step run for comparison")
    shutil.rmtree(CKPT + "_b", ignore_errors=True)
    t3 = make_trainer(device)
    t3.ckpt = type(t3.ckpt)(CKPT + "_b", ncf=4, mode="auto")
    ref = t3.run(40)

    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(state), tree_leaves(ref), strict=True))
    print(f"resumed-vs-uninterrupted bitwise identical: {same}")
    db = t2.ckpt.db
    print(f"checkpoint db: contexts={db.contexts()} files={db.n_files()} "
          f"(NCF=4 aggregation)")
    assert same


if __name__ == "__main__":
    main()
