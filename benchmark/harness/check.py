"""The comparison that decides ``correct``: the program's frames against
the plain reference's.

Each recording's answer is its kept frames in order, each as (start, frame
bytes, length, type, seq, src, dst, corr).  Two numbers are compared with
their limits (the configuration file's ``limits``):

* ``frames_differ``: frames of either side that the other lacks, matched
  on everything but the correlation value (an exact comparison);
* ``corr_gap``: the largest distance between the two sides' detection
  correlations of a matched frame.
"""

from __future__ import annotations

from collections import Counter


def compare(pairs, limits: dict) -> dict:
    """`pairs`: (the program's recordings, the reference's recordings) of
    each request checked."""
    differ, gap = 0, 0.0
    for program, reference in pairs:
        if len(program) != len(reference):
            raise ValueError("the answer and the reference hold different numbers of recordings")
        for prog, ref in zip(program, reference):
            a = Counter(f[:7] for f in prog)
            b = Counter(f[:7] for f in ref)
            differ += sum(((a - b) + (b - a)).values())
            if [f[:7] for f in prog] != sorted(f[:7] for f in prog) and not differ:
                differ += 1   # frames out of order
            ref_corr = {f[:7]: f[7] for f in ref}
            for f in prog:
                if f[:7] in ref_corr:
                    gap = max(gap, abs(f[7] - ref_corr[f[:7]]))
    return {"frames_differ": {"value": differ, "limit": limits["frames_differ"]},
            "corr_gap": {"value": gap, "limit": limits["corr_gap"]}}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
