"""Run one cell of BENCHMARK.json once, on the card of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Prints the result as one JSON line, last on
standard output; the numbers compared with the plain reference, each
beside its limit, are the last lines on standard error. Exits 2 without
a result where there is no CUDA device, or fewer than the cell asks for.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program at a fixed place inside
# the checkout, so that only a checkout's first run builds anything
_CACHE = ROOT / "build" / "portbench"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("REPRO_TORCH_BUILD_DIR", "repro_torch")):
    os.environ[_var] = str(_CACHE / _sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
