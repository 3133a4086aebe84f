"""Readings from which each cell's limits are set: sound runs, the witness and
the control.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 ... \
        --seconds <s> [--trace 0|1]

For each seed: one run of the cell as ``run.py`` makes it (set-up, the
measured window, the check), and then, for the same kept units,

* ``sound``: the program against the reference, the run's own check;
* ``witness``: a run that differs from the reference by round-off alone,
  against the reference: what a sound change of the program that only
  reorders sums may read (window: the reference on the host's CPU from the
  program's carry; batch: the reference on the drive with its odometry
  moved by 4 units in the last place);
* ``control``: the frozen reference in float32 wherever the configuration
  states float64, put in the program's place, against the reference.

Each driver gives the last two (``Driver.readings``). Prints one JSON line
a seed: ``{"seed", "result", "sound", "witness", "control"}``, each reading
the largest of every number over the kept units (appended to ``--out`` too,
where given). ``measure.py --readings`` runs it
once per seed, each seed its own process, so that ``result`` is a run as
the benchmark makes it. Runs on a CUDA device, or on the CPU with ``--cpu``
and ``--small`` (the test sizes).
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.run import STARTED  # noqa: E402  (first: the process's start, one thread)

import torch  # noqa: E402

from port_bench.harness import cells, runner  # noqa: E402


def _worst(rows: list) -> dict:
    out = {}
    for row in rows:
        for k, v in row.items():
            w = out.get(k, -math.inf)
            out[k] = v if (math.isnan(v) or math.isnan(w)) else max(w, v)
    return out



def small_overrides(driver: str) -> dict:
    """The CPU test sizes of each driver."""
    if driver == "window":
        glio = {"estimator": {"slide_window_width": 5, "local_map_width": 8, "sw_max_iter": 4,
                              "gnss_in_sliding_window": True, "doppler_in_window": True},
                "shapes": {"max_imu_per_interval": 40, "map_points": 1024, "max_sats": 20}}
        return {"traffic": {"scan_points": 64, "n_keyframes": 60},
                "config": {"glio": glio}, "run": {"warm_units": 8}}
    return {"traffic": {"n_keyframes": 120}}


def readings(name: str, seed: int, seconds: float, trace: bool, device, *,
             started: float = None, overrides: dict = None) -> dict:
    """One run of cell ``name`` and the readings of its kept units."""
    got = {}

    def after(drv):
        got["witness"], got["control"] = (_worst(rows) for rows in drv.readings())
    result = runner.run_cell(name, seed, seconds, trace, device=device, overrides=overrides,
                             started=time.time() if started is None else started, after=after)
    sound = {k: c["value"] for k, c in result["checks"].items()}
    return {"seed": seed, "result": result, "sound": sound, **got}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = None                     # the run's own choice of card
    else:
        raise SystemExit("control: no CUDA device (use --cpu for the test sizes)")
    over = None
    if args.small:
        over = small_overrides(cells.load_cell(args.workload).run["driver"])
    started = STARTED
    for seed in args.seeds:
        rec = readings(args.workload, seed, args.seconds, bool(args.trace), device,
                       started=started, overrides=over)
        started = None
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
