"""The card: the refusal to run without one, and the run's device record."""

import subprocess
import sys

import torch


def require_cuda(chips: int):
    """Exit without a result unless ``chips`` CUDA devices are visible."""
    if not torch.cuda.is_available():
        print("port_bench: torch.cuda.is_available() is false; the benchmark runs on "
              "a CUDA device only", file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        raise SystemExit(3)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of card 0, or "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def record(device: torch.device, chips: int) -> dict:
    """``platform``, ``kind``, ``count`` and ``memory_peak_bytes`` (the peak
    of allocated memory on the fullest card since the process started)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak)}
