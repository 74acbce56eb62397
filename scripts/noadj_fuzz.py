"""Mass fuzz of the noadj claim: the relaxed E-update (E opens from the
F-independent candidate cur' instead of cur = max(cur', F)) is exact for
EVERY scoring config (kernels/sw_lanes.py noadj_ok).

Runs thousands of random (matrix, gaps, pair) configs through a scalar
implementation of BOTH recurrences (the kernel's exact DP order) and the
classical oracle.  The kernel itself is A/B-verified against the oracle in
tests/test_adversarial.py (interpret mode) and the on-device parity
checks (utils/parity.py); this script is the breadth pass — cheap enough
to run 10^4 configs.

Usage, from the repository root:
    python -m scripts.noadj_fuzz [--configs 4000] [--maxlen 80]
Prints a JSON summary; exits 1 on any mismatch.
"""

import argparse
import json
import sys

import numpy as np


def sw_relaxed(a, b, sm, og, eg):
    """Scalar SW with the kernel's RELAXED E-update: E[i,j] opens from
    cur'[i,j-1] (the F-independent candidate) instead of H[i,j-1]."""
    oe = og + eg
    m, n = len(a), len(b)
    H = np.zeros(n, np.int64)      # H[i-1, :]
    CP = np.zeros(n, np.int64)     # cur'[i-1, :]
    F = np.zeros(n, np.int64)
    best = 0
    for i in range(m):
        diag = 0
        e_run = 0
        cp_left = 0
        for j in range(n):
            E_ij = max(cp_left - oe, e_run - eg)       # relaxed: from cur'
            F[j] = max(H[j] - oe, F[j] - eg)
            cp = max(0, diag + sm[a[i], b[j]], E_ij)   # F-independent
            h = max(cp, F[j])
            best = max(best, cp)                       # smax over cur'
            diag = H[j]
            H[j] = h
            CP[j] = cp
            cp_left = cp
            e_run = E_ij
    return int(best)


def sw_classic(a, b, sm, og, eg):
    oe = og + eg
    m, n = len(a), len(b)
    H = np.zeros(n, np.int64)
    F = np.zeros(n, np.int64)
    best = 0
    for i in range(m):
        diag = 0
        h_left = 0
        e_run = 0
        for j in range(n):
            E_ij = max(h_left - oe, e_run - eg)
            F[j] = max(H[j] - oe, F[j] - eg)
            h = max(0, diag + sm[a[i], b[j]], E_ij, F[j])
            best = max(best, h)
            diag = H[j]
            H[j] = h
            h_left = h
            e_run = E_ij
    return int(best)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--configs", type=int, default=4000)
    p.add_argument("--maxlen", type=int, default=80)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    rng = np.random.default_rng(args.seed)
    bad = []
    gap_pool = [0, 0, 1, 2, 3, 5, 10, 25, 100]
    for t in range(args.configs):
        kind = t % 3
        if kind == 0:
            sm = rng.integers(-12, 16, size=(24, 24))
        elif kind == 1:
            sm = rng.integers(0, 16, size=(24, 24))    # positive-heavy
        else:
            sm = rng.integers(-30, 31, size=(24, 24))  # wide range
        og = int(rng.choice(gap_pool))
        eg = int(rng.choice(gap_pool))
        la = int(rng.integers(1, args.maxlen))
        lb = int(rng.integers(1, args.maxlen))
        a = rng.integers(0, 24, la)
        b = rng.integers(0, 24, lb)
        w = sw_classic(a, b, sm, og, eg)
        g = sw_relaxed(a, b, sm, og, eg)
        if w != g:
            bad.append({"config": t, "og": og, "eg": eg, "kind": kind,
                        "classic": w, "relaxed": g})
            if len(bad) >= 5:
                break
        if (t + 1) % 500 == 0:
            print(f"{t + 1}/{args.configs} configs, "
                  f"{len(bad)} mismatches", file=sys.stderr)
    print(json.dumps({"configs": args.configs, "mismatches": len(bad),
                      "examples": bad}))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
