"""The numbers that decide ``correct``, each beside its limit."""

import math
import sys


def passes(value: float, limit: float) -> bool:
    return not math.isnan(value) and value <= limit


def report(checks: dict) -> bool:
    """Prints each check as the last lines on standard error; True when all pass."""
    ok = True
    for name, c in checks.items():
        good = passes(c["value"], c["limit"])
        ok &= good
        print(f"check {name}: {c['value']!r} <= {c['limit']!r} {'ok' if good else 'FAILED'}",
              file=sys.stderr)
    return ok


def gather(limits: dict, values: dict) -> dict:
    """{name: {"value", "limit"}} in the order of ``limits``; a number the
    comparison did not produce reads NaN and fails."""
    return {name: {"value": float(values.get(name, float("nan"))), "limit": float(limit)}
            for name, limit in limits.items()}
