"""The band-Cholesky kernels (``glio_tpu_torch/csrc/band_chol.cu``) at every
block size they are built for, on the card.

    python3 scripts/probe_torch_band_chol.py [--parent OLD/band_chol.cu]

Builds the source once more, as ``ops/_build.py`` builds it (D = 6, 7 and
15 at hw = 7, a library each, ``-DBAND_CHOL_D=D -DBAND_CHOL_HW=7``), with
``-Xptxas -v``, all builds at once into ``build/``, and prints each build's
seconds and its kernels' registers, stack frame, spill stores / loads and
SASS instruction count (``cuobjdump``); then, for D in {6, 7, 15} at T = 3493
and hw = 7 (the batch's Whampoa length and band), holds ``band_cholesky``
against ``block_cholesky`` (within 2e-5 of the largest entry, NaN rows
equal) and ``band_cholesky_solve`` against ``block_cholesky_solve``
(within the larger of 2e-5 of max |x| and 10x the plain version's f32
round-off against f64), on a random diagonally dominant band
(``testing.spd_band``), on the same band with block row 1500's diagonal
negated (a broken row) and with its blocks past offset 2 zeroed (the real
bands' exact-zero blocks: the factor's blocks m >= 3 are zeros), and times
both kernels on the first and the last (CUDA events, median of 20).

With ``--parent``, an older ``band_chol.cu`` (one that takes the same
definitions, as every source since the per-size builds does) is built the
same way beside it: its kernels must give the same bits as this source's at
every block size in ``ORDER_KEPT``, on every band, and print the largest
difference at the others; both are timed in turns (parent, this, this,
parent), so the two times come from one card. An older source:
``git show <commit>:glio_tpu_torch/csrc/band_chol.cu > build/parent_band_chol.cu``.
"""

import argparse
import ctypes
import os
import re
import statistics
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
SIZES = (6, 7, 15)
# Block sizes at which this source keeps the parent's order of operations,
# so its results must be the parent's bits.
ORDER_KEPT = (6, 7, 15)


def _defines(D):
    return (f"BAND_CHOL_D={D}", f"BAND_CHOL_HW={HW}")


def _sass_counts(lib):
    """SASS instructions of each kernel in the library ``lib``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.search(r"band_\w+_kernel", subprocess.run(
                ["c++filt", m.group(1)], capture_output=True, text=True).stdout)
            cur = cur.group(0) if cur else m.group(1)
            counts[cur] = 0
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[cur] += 1
    return counts


def ptxas_builds(builds):
    """Build each entry of ``builds`` ({name: (source, defines)}), all at
    once, with -Xptxas -v; print each build's seconds and its kernels'
    registers, stack frame, spills and SASS instructions. Returns {name:
    library}."""
    procs = {}
    for i, (name, (source, defines)) in enumerate(builds.items()):
        out = os.path.join(ROOT, "build", f"band_chol_probe_{i}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-Xptxas",
               "-v", "-o", out, source]
        procs[name] = (out, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, t0, proc) in procs.items():
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
                kernels[cur] = [0, 0, 0, 0]
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and cur:
                kernels[cur][1:] = [int(m.group(1)), int(m.group(2)), int(m.group(3))]
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                kernels[cur][0] = int(m.group(1))
        sass = _sass_counts(out)
        print(f"build {name}: {secs:.1f} s ({len(builds)} builds at once)", flush=True)
        for k, (regs, frame, st, ld) in sorted(kernels.items()):
            m = re.search(r"(band_\w+_kernel)<(\d+), (\d+)>", k)
            if m:
                print(f"  {m.group(1)}<D={m.group(2)}, hw={m.group(3)}>: {regs} registers, "
                      f"stack frame {frame} B, spill stores {st} B, spill loads {ld} B, "
                      f"{sass.get(m.group(1), 'n/a')} SASS instructions")
        libs[name] = out
    return libs


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


class Parent:
    """An older build's two kernels at one block size."""

    def __init__(self, path, D):
        self.lib, self.D = ctypes.CDLL(path), D

    def factor(self, band):
        out = torch.empty((T, HW + 1, self.D, self.D), device=band.device)
        err = self.lib.glio_band_chol_f32(
            ctypes.c_void_p(band.data_ptr()), ctypes.c_size_t(T), ctypes.c_size_t(HW),
            ctypes.c_size_t(self.D), ctypes.c_float(JITTER), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err == 0, f"the parent's factor returned {err}"
        return out

    def solve(self, Lb, b):
        x = torch.empty_like(b)
        err = self.lib.glio_band_chol_solve_f32(
            ctypes.c_void_p(Lb.data_ptr()), ctypes.c_void_p(b.data_ptr()), ctypes.c_size_t(T),
            ctypes.c_size_t(HW), ctypes.c_size_t(self.D), ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err == 0, f"the parent's solve returned {err}"
        return x


def against_parent(parent, D, band, good, b, L_k):
    """The parent's factor and solve against this source's: (factor equal,
    solve equal, largest factor difference of the largest entry, largest
    solve difference of max |x|)."""
    Lp = parent.factor(band)
    xp = parent.solve(good, b)
    x_k = band_chol.band_cholesky_solve(good, b)
    torch.cuda.synchronize()
    same_l = torch.equal(Lp.view(torch.int32), L_k.view(torch.int32))   # bits, signs of 0 too
    fin = torch.isfinite(Lp) & torch.isfinite(L_k)
    dl = float((Lp - L_k)[fin].abs().max()) / float(Lp[fin].abs().max())
    dx = float((xp - x_k).abs().max()) / float(xp.abs().max())
    return same_l, torch.equal(xp.view(torch.int32), x_k.view(torch.int32)), dl, dx


def in_turns(fa, fb, reps=20):
    """Median ms of ``fa`` and ``fb``, timed in turns a, b, b, a."""
    ta, tb = [], []
    for _ in range(2):
        ta.append(time_device_ms(fa, reps=reps // 2))
        tb.append(time_device_ms(fb, reps=reps // 2))
        tb.append(time_device_ms(fb, reps=reps // 2))
        ta.append(time_device_ms(fa, reps=reps // 2))
    return statistics.median(ta), statistics.median(tb)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older band_chol.cu, built and compared at every size")
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    source = str(_build.CSRC / "band_chol.cu")
    builds = {f"D={D}, hw={HW}": (source, _defines(D)) for D in SIZES}
    if args.parent:
        builds.update({f"parent D={D}, hw={HW}": (args.parent, _defines(D)) for D in SIZES})
    libs = ptxas_builds(builds)
    for D in SIZES:
        parent = Parent(libs[f"parent D={D}, hw={HW}"], D) if args.parent else None
        for case in ("random", "broken row 1500", "bandwidth 2"):
            band = spd_band(T, HW, D, device=dev)
            if case == "broken row 1500":
                band[1500, HW] = -band[1500, HW]
            elif case == "bandwidth 2":   # the factor's blocks m >= 3 are exact zeros
                band[:, :HW - 2] = 0
                band[:, HW + 3:] = 0
            rel, rel_s, roff, good, b, L_k = check_pair(D, band, dev)
            line = (f"D={D} T={T} hw={HW} {case}: factor {rel:.3e} of the largest entry from "
                    f"plain, solve {rel_s:.3e} of max |x| (plain f32 round-off {roff:.3e})")
            timed = case != "broken row 1500"
            if timed:
                ms = time_device_ms(lambda: band_chol.band_cholesky(band, JITTER), reps=20)
                ms_s = time_device_ms(lambda: band_chol.band_cholesky_solve(good, b), reps=20)
                line += (f"; factor {ms:.3f} ms ({1e3 * ms / T:.3f} us a row), solve "
                         f"{ms_s:.3f} ms ({1e3 * ms_s / T:.3f} us a row, both sweeps) "
                         f"(median of 20)")
            print(line, flush=True)
            if parent is None:
                continue
            same_l, same_x, dl, dx = against_parent(parent, D, band, good, b, L_k)
            if D in ORDER_KEPT:
                assert same_l and same_x, f"D = {D} differs from the parent ({dl}, {dx})"
                print(f"  D={D}: factor and solve bit-equal to {args.parent}'s")
            else:
                fac = "bit-equal" if same_l else f"{dl:.3e} of its largest entry"
                sol = "bit-equal" if same_x else f"{dx:.3e} of max |x|"
                print(f"  D={D}: factor {fac}, solve {sol} from {args.parent}'s")
            if timed:
                pf, nf = in_turns(lambda: parent.factor(band),
                                  lambda: band_chol.band_cholesky(band, JITTER))
                ps, ns = in_turns(lambda: parent.solve(good, b),
                                  lambda: band_chol.band_cholesky_solve(good, b))
                print(f"  D={D} {case} in turns (parent, this, this, parent; median of 20 "
                      f"each): factor {pf:.3f} -> {nf:.3f} ms ({pf / nf:.2f}x), solve "
                      f"{ps:.3f} -> {ns:.3f} ms ({ps / ns:.2f}x)", flush=True)
    print("probe_torch_band_chol: passed")


if __name__ == "__main__":
    main()
