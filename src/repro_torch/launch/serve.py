"""Serving launcher: batched prefill and decode.

``python -m repro_torch.launch.serve --arch mamba2_1_3b --smoke --tokens 32``

Runs on ``--device`` (the GPU by default; it raises without one unless
``--device cpu`` is passed). Parameters are drawn from ``--seed`` by the
reference's init rule; prompts and extras are seeded numpy, as in the
reference. Timings wait for the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..models import serving
from ..models.transformer import LM


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS, required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs on the "
                        "CPU)")
    args = p.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lm = LM(cfg, device=args.device)
    dev = lm.device
    params = lm.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    max_seq = args.prompt_len + args.tokens
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(
        np.int32)).to(dev)
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = torch.from_numpy((rng.standard_normal(
            (args.batch, cfg.n_patches, cfg.d_model)) * 0.1).astype(
            np.float32)).to(dev)
    if cfg.family == "encdec":
        extras["frames"] = torch.from_numpy((rng.standard_normal(
            (args.batch, cfg.n_frames, cfg.d_model)) * 0.1).astype(
            np.float32)).to(dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = serving.prefill(lm, params, prompts, extras=extras,
                                    max_seq=max_seq)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [torch.argmax(logits, -1).to(torch.int32)]
    t0 = time.perf_counter()
    for i in range(args.tokens - 1):
        logits, cache = serving.decode_step(lm, params, out[-1],
                                            args.prompt_len + i, cache)
        out.append(torch.argmax(logits, -1).to(torch.int32))
    _sync(dev)
    t_decode = time.perf_counter() - t0
    seqs = torch.stack(out, dim=1).cpu().numpy()
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill*1e3:.1f} ms")
    print(f"decode:  {args.tokens-1} steps x batch {args.batch} in "
          f"{t_decode*1e3:.1f} ms "
          f"({(args.tokens-1)*args.batch/max(t_decode,1e-9):.1f} tok/s)")
    print("sample token ids:", seqs[0, :16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
