"""Supervisor: relaunch a training subprocess until it completes.

The elastic/fault-tolerant outer loop: each attempt resumes from the
latest complete HProt context, so induced crashes (or preemptions) only
cost the steps since the last checkpoint. Exercised by
``chip_smoke.py`` phase 10 and ``tests/test_torch_trainer.py``.
"""
from __future__ import annotations

import os
import subprocess
import sys


def run_supervised(cmd: list[str], *, max_restarts: int = 5,
                   env: dict | None = None,
                   env_first: dict | None = None) -> tuple[int, int]:
    """Run ``cmd`` until exit 0 or restart budget exhausted.

    ``env_first`` applies only to the first attempt (e.g. an induced-crash
    trigger that models a one-off node failure).
    Returns (final_returncode, restarts_used).
    """
    restarts = 0
    while True:
        extra = env_first if restarts == 0 else None
        proc = subprocess.run(
            cmd, env={**os.environ, **(env or {}), **(extra or {})})
        if proc.returncode == 0:
            return 0, restarts
        restarts += 1
        print(f"[supervisor] child exited rc={proc.returncode}; "
              f"restart {restarts}/{max_restarts}", flush=True)
        if restarts >= max_restarts:
            return proc.returncode, restarts


def main(argv=None):
    argv = argv or sys.argv[1:]
    if not argv:
        print("usage: python -m repro_torch.train.supervisor -- <cmd...>")
        return 2
    if argv[0] == "--":
        argv = argv[1:]
    rc, n = run_supervised(argv)
    print(f"[supervisor] done rc={rc} after {n} restarts")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
