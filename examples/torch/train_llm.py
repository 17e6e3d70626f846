"""End-to-end training on the PyTorch + CUDA port (``repro_torch``), twin
of ``examples/train_llm.py``: train a ~100M-param LM for a few hundred
steps with the full production stack (WSD schedule, async Hercule HProt
checkpoints at one frequency, HDep analysis dumps at another: the
paper's fig. 1 dual flow).

    PYTHONPATH=src python examples/torch/train_llm.py [--steps 300] [--tiny] [--device cpu]

It trains on ``--device`` (the GPU unless ``cpu`` is asked for; without
a GPU it raises). ``--tiny`` (the size CI uses) keeps a CPU run short.
At the end it prints the throughput, the device's peak memory (the
GPU's), each save's stall on the train thread and the loss trajectory.
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.insitu.device import resolve_device  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

CKPT = os.path.join(tempfile.gettempdir(), "hx_train_llm_torch")


def model_100m() -> ModelConfig:
    """~100M params, stablelm-family layout."""
    return ModelConfig(
        name="hx-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=2048, vocab_size=32768,
        mlp_act="swiglu", remat="none")


def timed_saves(trainer) -> list:
    """Wrap ``trainer.ckpt.save``: the seconds each save holds the
    train thread (its stall), in order."""
    stalls, save = [], trainer.ckpt.save

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return save(*args, **kwargs)
        finally:
            stalls.append(time.perf_counter() - t0)
    trainer.ckpt.save = timed
    return stalls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced width/steps for CI")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' to train on the CPU")
    args = ap.parse_args()
    device = resolve_device(args.device)

    shutil.rmtree(CKPT, ignore_errors=True)
    shutil.rmtree(CKPT + "_hdep", ignore_errors=True)
    if args.tiny:
        cfg = dataclasses.replace(get_smoke_config("stablelm_1_6b"),
                                  name="hx-tiny")
        steps, seq, gbs = min(args.steps, 60), 128, 8
    else:
        cfg = model_100m()
        steps, seq, gbs = args.steps, 512, 8

    lm = LM(cfg, device=device)
    n_params = cfg.param_count()
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{steps} steps x {gbs}x{seq} tokens on {device}")
    trainer = Trainer(
        lm,
        opt_cfg=optim.OptConfig(lr=6e-4, warmup_steps=steps // 10,
                                stable_steps=int(steps * 0.7),
                                decay_steps=max(1, steps // 5)),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=gbs),
        ckpt_dir=CKPT, ckpt_every=max(10, steps // 5), ckpt_async=True,
        ncf=8, log_every=max(1, steps // 20),
        hdep_dir=CKPT + "_hdep", hdep_every=max(20, steps // 3),
        device=device)
    stalls = timed_saves(trainer)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer.run(steps)
    wall = time.perf_counter() - t0

    losses = [m["loss"] for m in trainer.metrics_log]
    k = max(1, len(losses) // 10)
    print(f"loss: first-{k}-avg {sum(losses[:k])/k:.4f} -> "
          f"last-{k}-avg {sum(losses[-k:])/k:.4f}")
    every = max(1, steps // 10)
    print("loss trajectory (every %d steps): %s" % (every, ", ".join(
        f"{m['step']}:{m['loss']:.4f}" for m in trainer.metrics_log[::every])))
    peak = f"{torch.cuda.max_memory_allocated(device)} bytes" \
        if device.type == "cuda" else "not measured"
    print(f"throughput: {steps / wall:.3f} steps/s, "
          f"{steps * gbs * seq / wall:.1f} tokens/s over {wall:.2f} s "
          f"(saves, dumps and the final wait included); peak device "
          f"memory: {peak}")
    print("save stalls (ms): " + ", ".join(f"{s * 1e3:.2f}" for s in stalls))
    print(f"HProt contexts: {trainer.ckpt.db.contexts()} in "
          f"{trainer.ckpt.db.n_files()} files")
    if trainer.hdep is not None:
        print(f"HDep analysis contexts: {trainer.hdep.contexts()}")
    assert sum(losses[-k:]) / k < sum(losses[:k]) / k
    print("losses fell")


if __name__ == "__main__":
    main()
