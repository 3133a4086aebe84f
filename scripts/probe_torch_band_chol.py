"""The band-Cholesky kernels (``glio_tpu_torch/csrc/band_chol.cu``) at every
block size they are built for, on the card.

    python3 scripts/probe_torch_band_chol.py [--parent OLD/band_chol.cu]

Builds the source once more, as ``ops/_build.py`` builds it (D = 6, 7 and
15 at hw = 7, a library each), with ``-Xptxas -v``, the three builds at
once into ``build/``, and prints each build's seconds and its kernels'
registers and spill stores / loads; then, for D in {6, 7, 15} at
T = 3493 and hw = 7 (the batch's Whampoa length and band), holds
``band_cholesky`` against ``block_cholesky`` (within 2e-5 of the largest
entry, NaN rows equal) and ``band_cholesky_solve`` against
``block_cholesky_solve`` (within the larger of 2e-5 of max |x| and 10x the
plain version's f32 round-off against f64), on a random diagonally dominant
band (``testing.spd_band``) and on the same band with block row 1500's
diagonal negated (a broken row), and times both kernels (CUDA events,
median of 20). With ``--parent``, the D = 6 kernels of that source (an
older ``band_chol.cu``, which builds D = 6 at every hw without definitions)
must give the same bits as this one's.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from glio_tpu_torch.ops import _build, band_chol  # noqa: E402
from glio_tpu_torch.solver import banded  # noqa: E402
from glio_tpu_torch.testing import spd_band, time_device_ms  # noqa: E402

T, HW, JITTER = 3493, 7, 3e-4


def ptxas_builds(builds):
    """Build ``band_chol.cu`` once per entry of ``builds`` ({name: defines}),
    all at once, with -Xptxas -v; print each build's seconds, how many of
    its kernels spill, and its hw = 7 kernels' registers and spills."""
    procs = {}
    for i, (name, defines) in enumerate(builds.items()):
        out = os.path.join(ROOT, "build", f"band_chol_ptxas_{i}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-Xptxas",
               "-v", "-o", out, str(_build.CSRC / "band_chol.cu")]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (t0, proc) in procs.items():
        log = proc.communicate()[0]
        secs = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(log)
        kernels, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                     text=True).stdout.strip()
                kernels[cur] = [0, 0, 0]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur:
                kernels[cur][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                kernels[cur][0] = int(m.group(1))
        print(f"build {name}: {secs:.1f} s ({len(builds)} builds at once), {len(kernels)} "
              f"kernels, {sum(v[1] > 0 for v in kernels.values())} spill", flush=True)
        for k, (regs, st, ld) in sorted(kernels.items()):
            m = re.search(r"(band_\w+_kernel)<(\d+), (\d+)>", k)
            if m and int(m.group(3)) == HW:
                print(f"  {m.group(1)}<D={m.group(2)}, hw={HW}>: {regs} registers, spill "
                      f"stores {st} B, spill loads {ld} B")


def check_pair(D, band, dev):
    """The kernels against their plain versions on ``band``; returns (factor
    and solve distances, the plain f32 round-off, the factor with broken
    rows made the identity, the right-hand side, the kernel's factor)."""
    L_k = band_chol.band_cholesky(band, JITTER)
    L_p = banded.block_cholesky(band, jitter=JITTER)
    fin = torch.isfinite(L_p)
    assert torch.equal(torch.isfinite(L_k), fin), "NaN rows differ"
    rel = float((L_k - L_p)[fin].abs().max()) / float(L_p[fin].abs().max())
    assert rel <= 2e-5, rel
    eye_row = torch.eye(D, device=dev).expand(T, HW + 1, D, D) * (
        torch.arange(HW + 1, device=dev) == 0)[None, :, None, None]
    good = torch.where(fin.reshape(T, -1).all(1)[:, None, None, None], L_p, eye_row)
    good = good.contiguous()
    b = torch.randn((T, D), device=dev, dtype=torch.float32)
    x_k = band_chol.band_cholesky_solve(good, b)
    x_p = banded.block_cholesky_solve(good, b)
    x_64 = banded.block_cholesky_solve(good.double(), b.double())
    scale = float(x_p.abs().max())
    roundoff = float((x_p.double() - x_64).abs().max()) / scale
    rel_s = float((x_k - x_p).abs().max()) / scale
    assert rel_s <= max(2e-5, 10 * roundoff), (rel_s, roundoff)
    return rel, rel_s, roundoff, good, b, L_k


def parent_equal(parent, band, good, b, L_k):
    """The older library's D = 6 factor and solve equal this one's, bit for bit."""
    lib = ctypes.CDLL(parent)
    Lp = torch.empty_like(L_k)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    size, ptr = ctypes.c_size_t, ctypes.c_void_p
    lib.glio_band_chol_f32(ptr(band.data_ptr()), size(T), size(HW), size(6),
                           ctypes.c_float(JITTER), ptr(Lp.data_ptr()), stream)
    xp = torch.empty_like(b)
    lib.glio_band_chol_solve_f32(ptr(good.data_ptr()), ptr(b.data_ptr()), size(T), size(HW),
                                 size(6), ptr(xp.data_ptr()), stream)
    torch.cuda.synchronize()
    return (torch.equal(torch.nan_to_num(Lp, 7.0), torch.nan_to_num(L_k, 7.0))
            and torch.equal(xp, band_chol.band_cholesky_solve(good, b)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older band_chol.cu whose D = 6 kernels must agree")
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ptxas_builds({f"D={D}, hw={HW}": (f"BAND_CHOL_D={D}", f"BAND_CHOL_HW={HW}")
                  for D in (6, 7, 15)})
    parent = None
    if args.parent:
        parent = os.path.join(ROOT, "build", "band_chol_parent.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", parent, args.parent],
                       check=True)
    for D in (6, 7, 15):
        for broken in (False, True):
            band = spd_band(T, HW, D, device=dev)
            if broken:
                band[1500, HW] = -band[1500, HW]
            rel, rel_s, roff, good, b, L_k = check_pair(D, band, dev)
            line = (f"D={D} T={T} hw={HW}{' broken row 1500' if broken else ''}: factor "
                    f"{rel:.3e} of the largest entry from plain, solve {rel_s:.3e} of max |x| "
                    f"(plain f32 round-off {roff:.3e})")
            if not broken:
                ms = time_device_ms(lambda: band_chol.band_cholesky(band, JITTER), reps=20)
                ms_s = time_device_ms(lambda: band_chol.band_cholesky_solve(good, b), reps=20)
                line += f"; factor {ms:.3f} ms, solve {ms_s:.3f} ms (median of 20)"
            print(line, flush=True)
            if parent and D == 6:
                assert parent_equal(parent, band, good, b, L_k), "D = 6 differs from the parent"
                print(f"  D=6 factor and solve bit-equal to {args.parent}'s")
    print("probe_torch_band_chol: passed")


if __name__ == "__main__":
    main()
