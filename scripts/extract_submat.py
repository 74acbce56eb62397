#!/usr/bin/env python3
"""One-time extraction of the 8 public BLOSUM/PAM substitution matrices.

The matrices (BLOSUM45/50/62/80/90, PAM30/70/250) are standard public-domain
scientific constants (NCBI).  The reference engine stores them in a specific
alphabet order (A B C D E F G H I K L M N P Q R S T V W X Y Z, i.e. 'A'..'Z'
with J/O/U removed; see /root/reference/host/src/sequences.c:164-175 and
submat.c).  Score parity with the reference requires bit-identical tables, so
this script parses the numeric literals out of the reference's submat.c once
and stores them as a [8, 24, 24] int8 array in oswald_tpu/data/submat.npz.

Dev-time tool only: the produced .npz is committed; nothing at runtime reads
the reference.

Usage: python scripts/extract_submat.py <reference>/host/src/submat.c
"""

import os
import re
import sys

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "oswald_tpu", "data", "submat.npz")
NAMES = ["blosum45", "blosum50", "blosum62", "blosum80", "blosum90",
         "pam30", "pam70", "pam250"]


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__.strip().splitlines()[-1])
    text = open(sys.argv[1]).read()
    mats = {}
    for name in NAMES:
        m = re.search(r"char\s+%s\s*\[\]\s*__attribute__[^=]*=\s*\{(.*?)\};"
                      % name, text, re.S)
        if not m:
            sys.exit(f"matrix {name} not found")
        vals = [int(v) for v in re.findall(r"-?\d+", m.group(1))]
        assert len(vals) == 24 * 32, (name, len(vals))
        arr = np.array(vals, dtype=np.int8).reshape(24, 32)
        # columns 23..31 are padding for the reference's 32-byte SIMD rows;
        # keep column 23 (dummy) -> [24, 24]
        assert (arr[:, 24:] == 0).all()
        assert (arr[23, :] == 0).all(), "dummy row must be zero"
        mats[name] = arr[:, :24]

    # sanity spot checks (standard published values, alphabet A..Z minus JOU)
    b62 = mats["blosum62"].astype(int)
    A, C, W, Y = 0, 2, 19, 21
    assert b62[A][A] == 4 and b62[W][W] == 11 and b62[C][C] == 9
    assert b62[A][C] == 0 and b62[W][Y] == 2
    for n in NAMES:
        sq = mats[n][:23, :23].astype(int)
        assert (sq == sq.T).all(), f"{n} not symmetric"

    np.savez_compressed(OUT, **mats)
    print("wrote", OUT, "matrices:", ", ".join(NAMES))


if __name__ == "__main__":
    main()
