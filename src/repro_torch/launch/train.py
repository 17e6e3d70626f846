"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Runs the real training loop on ``--device`` (the GPU by default; it
raises without one unless ``--device cpu`` is passed) with Hercule HProt
checkpointing; resume is automatic.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import ARCHS, PORT_ARCHS, get_config, get_smoke_config
from ..data.pipeline import DataConfig
from ..models.transformer import LM
from ..train import optim
from ..train.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS + PORT_ARCHS, required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "hx_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--ckpt-mode", default="raw",
                   choices=["raw", "delta", "pyramid", "auto"])
    p.add_argument("--ckpt-async", action="store_true",
                   help="HProt async checkpointing: device-side snapshot "
                        "only on the train thread; encode/write/fsync "
                        "behind staged writer lanes")
    p.add_argument("--ckpt-delta-every", type=int, default=0, metavar="K",
                   help="with --ckpt-async: K incremental delta "
                        "checkpoints between full rebases (0 = always full)")
    p.add_argument("--ckpt-lane-backend", default="thread",
                   choices=["thread", "process"],
                   help="async checkpoint writer lanes: in-process "
                        "threads, or one OS process per contributor group")
    p.add_argument("--ncf", type=int, default=8,
                   help="Hercule contributors per file")
    p.add_argument("--hdep-dir", default=None)
    p.add_argument("--hdep-every", type=int, default=0)
    p.add_argument("--insitu-dir", default=None,
                   help="in-transit reduced HDep output "
                        "(repro_torch.insitu)")
    p.add_argument("--insitu-every", type=int, default=0)
    p.add_argument("--insitu-policy", default="drop-oldest",
                   choices=["block", "drop-oldest", "subsample"])
    p.add_argument("--insitu-domains", type=int, default=1,
                   help="in-transit contributor groups (reduced objects "
                        "are written one domain per group, merged at read)")
    p.add_argument("--insitu-backend", default="thread",
                   choices=["thread", "process"],
                   help="lane runtime: in-process worker threads, or one "
                        "OS process per group over shared-memory staging")
    p.add_argument("--insitu-device-reduce", action="store_true",
                   help="stage train-state snapshots on --device (a "
                        "device-to-device clone) and transfer only "
                        "reduced objects")
    p.add_argument("--insitu-device-mesh", type=int, default=0,
                   metavar="N",
                   help="shard in-transit AMR reductions over N devices "
                        "(the first N GPUs, or N shards on --device when "
                        "it is given; 0 = off)")
    p.add_argument("--insitu-trace-out", default=None, metavar="PATH",
                   help="record the training step's spans (with or "
                        "without an in-transit engine) and the engine's, "
                        "and write a Chrome-trace JSON (Perfetto) when "
                        "training finishes")
    p.add_argument("--ledger", action="store_true",
                   help="persist a run ledger (metrics/spans/events/"
                        "attribution/health) into <insitu-dir or "
                        "ckpt-dir>/telemetry/; inspect with "
                        "python -m repro_torch.launch.obs")
    p.add_argument("--ledger-interval", type=float, default=2.0,
                   help="seconds between background ledger flushes")
    p.add_argument("--metrics-port", type=int, default=None, metavar="P",
                   help="expose a Prometheus /metrics endpoint from the "
                        "trainer process on this port (0 = ephemeral)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device of the model, the train step and "
                        "--insitu-device-reduce (default: cuda; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lm = LM(cfg, device=args.device)
    trainer = Trainer(
        lm,
        opt_cfg=optim.OptConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10),
                                stable_steps=args.steps, decay_steps=args.steps // 5 + 1),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                            global_batch=args.global_batch, seed=args.seed),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        ckpt_mode=args.ckpt_mode, ncf=args.ncf,
        ckpt_async=args.ckpt_async,
        ckpt_delta_every=args.ckpt_delta_every,
        ckpt_lane_backend=args.ckpt_lane_backend,
        hdep_dir=args.hdep_dir, hdep_every=args.hdep_every,
        insitu_dir=args.insitu_dir, insitu_every=args.insitu_every,
        insitu_policy=args.insitu_policy,
        insitu_domains=args.insitu_domains,
        insitu_backend=args.insitu_backend,
        insitu_device_reduce=args.insitu_device_reduce,
        insitu_device_mesh=args.insitu_device_mesh,
        insitu_trace_out=args.insitu_trace_out,
        ledger=args.ledger, ledger_interval=args.ledger_interval,
        metrics_port=args.metrics_port,
        seed=args.seed, device=args.device)
    trainer.run(args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
