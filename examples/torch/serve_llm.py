"""Batched serving demo across architecture families on the PyTorch +
CUDA port (``repro_torch``), twin of ``examples/serve_llm.py``: prefill
+ decode with per-family caches (KV ring buffer / SSM state / RG-LRU
state).

    PYTHONPATH=src python examples/torch/serve_llm.py [--device cpu]

Each family is served by ``python -m repro_torch.launch.serve`` on
``--device`` (the GPU unless ``cpu`` is asked for; without a GPU the
server raises).
"""
import argparse
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "..", "src")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' to serve on the CPU")
    args = ap.parse_args()
    env = {**os.environ, "PYTHONPATH": SRC}
    device = ["--device", args.device] if args.device else []
    for arch in ("stablelm_1_6b", "mamba2_1_3b", "recurrentgemma_2b",
                 "mixtral_8x22b"):
        print(f"== {arch} (smoke config)", flush=True)
        subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
             "--smoke", "--batch", "4", "--prompt-len", "16",
             "--tokens", "16", *device],
            env=env, check=True)
    print("every family served")


if __name__ == "__main__":
    main()
