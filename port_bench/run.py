"""Runs one cell of the port's benchmark once and prints its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port
(``glio_tpu_torch``). Without a CUDA device, or with fewer than the cell
asks for, it exits with code 3 and prints no result. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, every number compared beside its limit (also the last lines of
standard error).
"""

import argparse
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


STARTED = _process_start()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# One host thread for the CPU libraries: the port drives the card from one
# Python thread, and idle pools of worker threads only add jitter to it.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    from port_bench.harness import runner
    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             started=STARTED)
    return runner.finish(result)


if __name__ == "__main__":
    sys.exit(main())
