"""Integer ambiguity resolution (ILS with lattice decorrelation); a copy of
``glio_tpu/gnss/lambda_ar.py``, which is jax-free host numpy.

Fills the role of the reference's LAMBDA stage (RTKLIB ``lambda.c``,
exercised by its manual smoke node
``global_fusion/src/testRTKLIBNode.cpp``): given float double-difference
ambiguities and their covariance, find the best integer vectors under the
covariance metric and apply the conditional fixed-position update.

Provenance: the underlying method (decorrelating unimodular transform +
depth-first conditional integer search) is the published (M)LAMBDA
algorithm — Teunissen 1995; Chang, Yang & Zhou, J. Geodesy 2005. This
implementation was written from that algorithmic description and is
organized differently from RTKLIB's ``lambda.c``:

* factorization is a *forward* Q = L·diag(d)·Lᵀ (unit lower L, row
  order), so the conditional search roots at index 0 and descends to
  n−1 (RTKLIB factors Q = Lᵀ·D·L and searches from n−1 down);
* the decorrelation works on the covariance itself — sweeps of
  {refactorize, integer size-reduction as row operations on a running
  unimodular M with Qz = M·Q·Mᵀ, one Lovász-style adjacent swap} until
  a sweep makes no swap — rather than incremental 2×2 updates of a
  cached factorization;
* the search enumerates each level by a counter-indexed zigzag offset
  (closed form, ordered by distance from the conditional mean) and
  keeps the m-best candidates in a ``heapq`` max-heap.

Correctness is pinned by brute-force enumeration over integer boxes in
``tests/test_lambda_ar.py``.

Host-side numpy by design: the search is an inherently sequential integer
tree walk over a handful of ambiguities per epoch — not a tensor op; it
runs once per epoch on the float filter's output (``rtk.float_filter``),
off the jit path.

``resolve_epoch`` additionally applies the conditional (fixed) position
update p_fix = p − P_pa Q_a⁻¹ (a − ǎ) and the standard ratio test.
"""

import heapq
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np


def ldl(Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Factor Q = L · diag(d) · Lᵀ, L unit lower triangular (row order).

    d[i] is the conditional variance of component i given components
    0..i−1, so a search that fixes z₀ first needs no reordering of the
    factor. Raises ``LinAlgError`` if Q is not positive definite.
    """
    Q = np.asarray(Q, float)
    n = Q.shape[0]
    L = np.eye(n)
    d = np.empty(n)
    for i in range(n):
        # Row recurrence: Q[i,j] = Σ_k L[i,k] d[k] L[j,k] for j ≤ i.
        for j in range(i):
            L[i, j] = (Q[i, j] - (L[i, :j] * d[:j]) @ L[j, :j]) / d[j]
        d[i] = Q[i, i] - (L[i, :i] ** 2) @ d[:i]
        if d[i] <= 0.0:
            raise np.linalg.LinAlgError("Q not positive definite")
    return L, d


def decorrelate(Q: np.ndarray, max_sweeps: int = 1000):
    """Unimodular decorrelation: returns (M, L, d) with Qz = M·Q·Mᵀ =
    L·diag(d)·Lᵀ size-reduced (|L[i,j]| ≤ ½) and swap-stable.

    Each sweep refactorizes the current Qz, size-reduces every
    subdiagonal entry by integer row operations z_i ← z_i − μ·z_j
    (applied to M; the factor row updates as L_i ← L_i − μ·L_j), then
    applies at most one adjacent interchange where conditioning the
    earlier-searched slot on the swap strictly shrinks its conditional
    variance (relative tolerance 1e−9). Terminates when a sweep swaps
    nothing. O(n³) per sweep — irrelevant at GNSS sizes (n ≤ ~15).
    """
    Q = np.asarray(Q, float)
    n = Q.shape[0]
    M = np.eye(n)
    for _ in range(max_sweeps):
        Qz = M @ Q @ M.T
        L, d = ldl(Qz)
        # Size reduction: j from i−1 downward so each move only touches
        # L entries at or left of column j (already-final ones stay).
        for i in range(1, n):
            for j in range(i - 1, -1, -1):
                mu = float(np.rint(L[i, j]))
                if mu != 0.0:
                    L[i, : j + 1] -= mu * L[j, : j + 1]
                    M[i, :] -= mu * M[j, :]
        swapped = False
        for i in range(n - 1):
            # Post-swap conditional variance of search level i.
            d_swap = d[i + 1] + L[i + 1, i] ** 2 * d[i]
            if d_swap < d[i] * (1.0 - 1e-9):
                M[[i, i + 1], :] = M[[i + 1, i], :]
                swapped = True
                break
        if not swapped:
            return M, L, d
    return M, L, d


def _zigzag(c: int, toward: int) -> int:
    """c-th offset from the rounded conditional mean, ordered by
    distance: 0, ±1, ∓1, ±2, ∓2, … with the first step toward the
    fractional side (`toward` ∈ {+1, −1})."""
    if c == 0:
        return 0
    half = (c + 1) // 2
    return half * toward if c % 2 else -half * toward


def search(L: np.ndarray, d: np.ndarray, a: np.ndarray, m: int = 2,
           max_nodes: int = 100000):
    """m-best integer least squares under (z−a)ᵀ(L·diag(d)·Lᵀ)⁻¹(z−a).

    Depth-first conditional search rooted at level 0: with
    u_k = z_k − mean_k and mean_k = a_k + L[k,:k]·u[:k], the objective
    is Σ u_k²/d_k, accumulated level by level. Each level enumerates
    integers in zigzag order (non-decreasing |u_k|), so the first value
    that breaches the current bound exhausts the level. The m best
    full-depth vectors live in a max-heap; the bound is the heap's worst
    value once it holds m entries. Returns (vectors (≤m, n) int64,
    values (≤m,)) sorted ascending.
    """
    n = d.shape[0]
    mean = np.zeros(n)
    u = np.zeros(n)
    acc = np.zeros(n)          # acc[k] = Σ_{i<k} u_i²/d_i
    z = np.zeros(n)
    cnt = np.zeros(n, np.int64)
    toward = np.ones(n, np.int64)
    heap = []                  # (−value, tiebreak, z copy) max-heap
    pushes = 0
    bound = math.inf

    mean[0] = a[0]
    k = 0
    nodes = 0
    while nodes < max_nodes:
        nodes += 1
        base = float(np.rint(mean[k]))
        if cnt[k] == 0:
            toward[k] = 1 if mean[k] >= base else -1
        z[k] = base + _zigzag(int(cnt[k]), int(toward[k]))
        u[k] = z[k] - mean[k]
        t = acc[k] + u[k] * u[k] / d[k]
        if t < bound:
            if k == n - 1:
                heapq.heappush(heap, (-t, pushes, z.copy()))
                pushes += 1
                if len(heap) > m:
                    heapq.heappop(heap)
                if len(heap) == m:
                    bound = -heap[0][0]
                cnt[k] += 1
            else:
                acc[k + 1] = t
                k += 1
                cnt[k] = 0
                mean[k] = a[k] + L[k, :k] @ u[:k]
        else:
            # Zigzag is distance-ordered: siblings only get worse.
            if k == 0:
                break
            k -= 1
            cnt[k] += 1
    out = sorted(((-negv, zz) for negv, _, zz in heap), key=lambda p: p[0])
    vecs = np.array([zz for _, zz in out], np.int64).reshape(len(out), n)
    vals = np.array([v for v, _ in out])
    return vecs, vals


def lambda_ar(a: np.ndarray, Q: np.ndarray, ncands: int = 2):
    """Integer least squares: float ambiguities + covariance → the
    ncands best integer candidates under the covariance metric.

    Returns (cands (ncands, n) int, sq (ncands,) quadratic values) —
    empty arrays when the factorization fails (singular Q)."""
    a = np.asarray(a, float)
    try:
        M, L, d = decorrelate(Q)
    except np.linalg.LinAlgError:
        return np.zeros((0, len(a)), np.int64), np.zeros(0)
    zc, sq = search(L, d, M @ a, m=ncands)
    if zc.shape[0] == 0:
        return zc, sq
    # Back-transform candidates: a_cand = M⁻¹ z (M unimodular → integer).
    cands = np.rint(np.linalg.solve(M, zc.T)).T.astype(np.int64)
    return cands, sq


class FixResult(NamedTuple):
    pos_fixed: np.ndarray     # (3,) conditional fixed position
    amb_fixed: np.ndarray     # (n_dd,) integer DD ambiguities (cycles)
    ratio: float              # s2/s1 ratio-test statistic
    fixed: bool               # ratio test passed


def resolve_epoch(pos: np.ndarray, amb_sd: np.ndarray,
                  amb_cov_sd: np.ndarray, pa_cov: np.ndarray,
                  pair_idx: np.ndarray, master_idx: np.ndarray,
                  wavelength, ratio_thresh: float = 3.0,
                  min_dd: int = 4, max_dd: int = 12) -> Optional[FixResult]:
    """Fix one epoch from the float filter's state.

    Args:
      pos, amb_sd, amb_cov_sd, pa_cov: float solution blocks (SD
        ambiguities in metres, slot space).
      pair_idx, master_idx: (n_dd,) slot indices forming DD pairs
        (non-master, master-of), carrier-valid only.
      wavelength: carrier wavelength(s) (m) to convert to cycles —
        scalar, or (n_dd,) per pair (GPS L1 vs BDS B1 differ by ~1%,
        which is ~1 cycle past |a| ≈ 55 cycles; FDMA pairs whose two
        satellites have different λ are not integer in any common unit
        and must not be passed here).

    Returns None when the problem is degenerate (too few pairs). The
    ratio test s₂/s₁ ≥ thresh gates the fix (RTKLIB default 3.0).
    """
    n = len(pair_idx)
    if n < min_dd:
        return None
    lam = np.broadcast_to(np.asarray(wavelength, float), (n,)).copy()
    if n > max_dd:
        # Keep the best-determined pairs (smallest variance) — bounded
        # search cost, like RTKLIB's partial fixing.
        var = np.array([amb_cov_sd[i, i] for i in pair_idx])
        keep = np.argsort(var)[:max_dd]
        pair_idx = np.asarray(pair_idx)[keep]
        master_idx = np.asarray(master_idx)[keep]
        lam = lam[keep]
        n = max_dd
    D = np.zeros((n, amb_sd.shape[0]))
    D[np.arange(n), pair_idx] = 1.0
    D[np.arange(n), master_idx] -= 1.0
    a_dd = (D @ amb_sd) / lam
    Q_dd = (D @ amb_cov_sd @ D.T) / np.outer(lam, lam)
    Q_dd = 0.5 * (Q_dd + Q_dd.T) + 1e-12 * np.eye(n)
    cands, sq = lambda_ar(a_dd, Q_dd)
    if cands.shape[0] < 2:
        return None
    ratio = float(sq[1] / max(sq[0], 1e-12))
    a_fix = cands[0]
    # Conditional update: p̌ = p − P_pa Dᵀ diag(1/λ) Q_dd⁻¹ (a − ǎ).
    try:
        w = np.linalg.solve(Q_dd, a_dd - a_fix)
    except np.linalg.LinAlgError:
        return None
    pos_fixed = pos - (pa_cov @ D.T / lam[None, :]) @ w
    return FixResult(pos_fixed=pos_fixed, amb_fixed=a_fix, ratio=ratio,
                     fixed=ratio >= ratio_thresh)


# Per-constellation L1-band wavelengths (m); GLONASS is FDMA —
# per-satellite λ — so its pairs are excluded from integer resolution.
SYS_LAMBDA = {0: 299792458.0 / 1.57542e9,    # GPS L1
              2: 299792458.0 / 1.57542e9,    # GAL E1
              3: 299792458.0 / 1.561098e9}   # BDS B1
SYS_GLO = 1


def resolve_trajectory(gnss, flt, wavelength=None, ratio_thresh: float = 3.0):
    """Run the ratio-tested fix over every filter epoch.

    Args:
      gnss: GnssEpochs (for pair structure / carrier validity).
      flt: FloatFilterOut from ``rtk.float_filter``.
      wavelength: scalar λ override (tests/single-constellation sims);
        default None uses the per-constellation SYS_LAMBDA table and
        skips GLONASS (FDMA) pairs.

    Returns (pos (E, 3) — fixed where possible else float, fixed (E,)
    bool, ratio (E,)).
    """
    E, M = np.asarray(gnss.valid).shape
    pos = np.array(flt.pos)
    fixed = np.zeros(E, bool)
    ratio = np.zeros(E)
    valid = np.asarray(gnss.valid)
    car_ok = (np.asarray(gnss.car_valid)
              if gnss.car_valid is not None else np.zeros((E, M), bool))
    system = np.asarray(gnss.system)
    master = np.asarray(gnss.master)
    amb = np.asarray(flt.amb)
    amb_cov = np.asarray(flt.amb_cov)
    pa_cov = np.asarray(flt.pa_cov)
    ok = np.asarray(flt.ok)
    for k in range(E):
        if not ok[k]:
            continue
        pairs, masters, lams = [], [], []
        for s in range(master.shape[1]):
            mp = master[k, s]
            if mp < 0 or not car_ok[k, mp]:
                continue
            if s == SYS_GLO:
                # FDMA: inter-satellite DD ambiguities are non-integer
                # for ANY single wavelength — skip even under a scalar
                # override (a caller's λ is for CDMA sims; feeding
                # GLONASS pairs through the integer search would poison
                # the fix silently — ADVICE r2).
                continue
            lam_s = (wavelength if wavelength is not None
                     else SYS_LAMBDA.get(s))
            if lam_s is None:
                continue
            for m in range(M):
                if (m != mp and valid[k, m] and car_ok[k, m]
                        and system[k, m] == s):
                    pairs.append(m)
                    masters.append(mp)
                    lams.append(lam_s)
        res = resolve_epoch(pos[k], amb[k], amb_cov[k], pa_cov[k],
                            np.asarray(pairs, int),
                            np.asarray(masters, int),
                            np.asarray(lams, float), ratio_thresh)
        if res is not None and res.fixed:
            pos[k] = res.pos_fixed
            fixed[k] = True
            ratio[k] = res.ratio
        elif res is not None:
            ratio[k] = res.ratio
    return pos, fixed, ratio
