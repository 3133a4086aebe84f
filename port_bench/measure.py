"""Sets of runs of one cell, and the spread of each metric, for setting bounds.

    python3 port_bench/measure.py --workload <cell> --seeds 1 2 3 4 5 6 \
        --seconds <run_seconds> [--sets 2] [--trace 0] [--readings]

Runs ``port_bench/run.py`` once per seed, one process at a time, for each of
``--sets`` sets with the same seeds (with ``--readings``, ``control.py`` in
the first set, which makes the same run and then reads the witness and the
control of its kept units); prints every result line with its set, seed and wall time (and
appends it to ``--out``, where given); and prints,
for each metric and set, the median and the spread (the distance between
the first and third quartiles of ``statistics.quantiles(values, n=4)`` as a
share of the median), and the count of runs that were not correct.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--readings", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    runs = []
    for s in range(args.sets):
        # The witness and the control are read in the first set only: the
        # other sets repeat its seeds.
        readings = args.readings and s == 0
        script, seed_flag = ("control.py", "--seeds") if readings else ("run.py", "--seed")
        for seed in args.seeds:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, str(ROOT / "port_bench" / script),
                                "--workload", args.workload, seed_flag, str(seed),
                                "--seconds", str(args.seconds), "--trace", str(args.trace)],
                               cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                res = None
                sys.stderr.write(p.stderr[-4000:])
            rec = {"set": s, "seed": seed, "rc": p.returncode, "wall_s": wall}
            if readings and res is not None:
                rec.update((k, res[k]) for k in ("sound", "witness", "control"))
                res = res["result"]
            rec["result"] = res
            runs.append(rec)
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    for s in range(args.sets):
        mine = [r["result"] for r in runs if r["set"] == s and r["result"]]
        bad = sum(not r["correct"] for r in mine)
        names = sorted({k for r in mine for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in mine if name in r["metrics"]]
            if len(vals) >= 2:
                print(f"set {s} {name}: median {statistics.median(vals)!r} "
                      f"spread {spread(vals)!r} over {len(vals)} runs; "
                      f"not correct {bad}", flush=True)


if __name__ == "__main__":
    main()
