"""Differential test: secondary_refine.sdp_interval_align vs the reference
binary's own SDPAlign (alignment/SDPMatcher.cpp compiled as sdpMatcher).

sdpMatcher prints qstart/qend/tstart/tend and the SDPAlign RETURN value,
which is the block-only ComputeAlignmentScore (gap lists absent -> gaps
free, AlignmentUtils.h:143); the harness therefore compares spans and the
block-only score. Invocation mirrors SDPMatcher.cpp's parameter plumbing:
k, -local, -indel I (scoreFn ins=del), -sdpIndel S (chain ins=del),
-indelRate R, refine on, extendFront false, sdpPrefixLength 0.

Usage: python scripts/sdp_diff.py [n_cases] [path-to-sdpMatcher]
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

BASES = "ACGT"


def to_str(codes):
    return "".join(BASES[c] for c in codes)


def gen_case(rng, kind):
    """(query, target) pairs covering the shapes the secondary gate sees."""
    if kind == 0:      # mutated full copy
        t = rng.integers(0, 4, rng.integers(300, 1200))
        q = t.copy()
        mut = rng.random(len(q)) < rng.uniform(0.02, 0.15)
        q[mut] = (q[mut] + rng.integers(1, 4, mut.sum())) % 4
        pad = rng.integers(0, 4, 100)
        return q, np.concatenate([pad, t, pad])
    if kind == 1:      # partial: only a middle slice matches
        t = rng.integers(0, 4, 1000)
        q = rng.integers(0, 4, 800)
        s = rng.integers(0, 500)
        q[200:500] = t[s : s + 300]
        return q, t
    if kind == 2:      # junk
        return rng.integers(0, 4, 700), rng.integers(0, 4, 900)
    if kind == 3:      # indel bursts
        t = rng.integers(0, 4, 900)
        q = np.concatenate(
            [t[100:400], rng.integers(0, 4, 80), t[400:700]]
        )
        mut = rng.random(len(q)) < 0.08
        q[mut] = (q[mut] + 1) % 4
        return q, t
    if kind == 4:
        # repeated family: two diverged copies of one template
        tpl = rng.integers(0, 4, 400)
        c1 = tpl.copy()
        m = rng.random(400) < 0.1
        c1[m] = (c1[m] + 1) % 4
        t = np.concatenate(
            [rng.integers(0, 4, 50), tpl, rng.integers(0, 4, 100), c1]
        )
        q = tpl.copy()
        m = rng.random(400) < 0.08
        q[m] = (q[m] + 1) % 4
        return q, t
    if kind == 5:
        # two matching islands bridged by a BIG junk gap: drives the
        # detailed-gap recursion (gap cells >= noRecurseUnder -> word-7
        # Global SDP -> word-5 -> SW), the deepest code path
        t = rng.integers(0, 4, 1400)
        q = np.concatenate(
            [t[100:400], rng.integers(0, 4, 450), t[900:1300]]
        )
        mut = rng.random(len(q)) < 0.06
        q[mut] = (q[mut] + 1) % 4
        return q, t
    # diverged copy at ~25-35% error: sparse word-11 fragments, most
    # coverage comes from recursive gap alignment
    t = rng.integers(0, 4, 1000)
    q = t[100:900].copy()
    mut = rng.random(len(q)) < rng.uniform(0.25, 0.35)
    q[mut] = (q[mut] + rng.integers(1, 4, mut.sum())) % 4
    return q, t


def block_only_score(blocks, q, t, match=-5, mismatch=6, n_score=0):
    s = 0
    for bq, bt, bl in blocks:
        qc = q[bq : bq + bl].astype(np.int16)
        tc = t[bt : bt + bl].astype(np.int16)
        anyn = (qc >= 4) | (tc >= 4)
        s += int(np.where(anyn, n_score, np.where(qc == tc, match, mismatch)).sum())
    return s


def main():
    from blasr_jax.pipeline.secondary_refine import sdp_interval_align

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    matcher = (
        sys.argv[2] if len(sys.argv) > 2
        else "/tmp/refbuild/alignment/bin/sdpMatcher"
    )
    rng = np.random.default_rng(11)
    word, sdp_indel, indel, rate = 11, 5, 5, 0.9
    n_bad = 0
    for case in range(n):
        kind = case % 7
        local = (case // 7) % 2 == 0     # alternate Local / Global type
        q, t = gen_case(rng, kind)
        with open("/tmp/sdpq.fa", "w") as f:
            f.write(">q\n" + to_str(q) + "\n")
        with open("/tmp/sdpt.fa", "w") as f:
            f.write(">t\n" + to_str(t) + "\n")
        out = subprocess.run(
            [matcher, "/tmp/sdpq.fa", "/tmp/sdpt.fa", str(word)]
            + (["-local"] if local else [])
            + ["-indel", str(indel), "-sdpIndel", str(sdp_indel),
               "-indelRate", str(rate)],
            capture_output=True, text=True,
        )
        lines = [l for l in out.stdout.splitlines() if l and not l.startswith("qid")]
        if not lines:
            ref = None
        else:
            f = lines[0].split(",")
            # sdpMatcher prints qPos/tPos plus block-RELATIVE ends
            ref = dict(qs=int(f[2]), qe=int(f[2]) + int(f[3]),
                       ts=int(f[5]), te=int(f[5]) + int(f[6]),
                       score=int(f[8]))
            if ref["qe"] == ref["qs"]:   # empty alignment row
                ref = None
        _, blocks = sdp_interval_align(
            q, t, word=word, sdp_ins=sdp_indel, sdp_del=sdp_indel,
            ins=indel, dele=indel, indel_rate=rate, prefix_len=0,
            recurse=3, no_recurse_under=10000,  # SDPAlign signature
                                                # defaults, what sdpMatcher
                                                # passes implicitly
            _align_type="local" if local else "global",
        )
        if blocks:
            mine = dict(
                qs=blocks[0][0], qe=blocks[-1][0] + blocks[-1][2],
                ts=blocks[0][1], te=blocks[-1][1] + blocks[-1][2],
                score=min(block_only_score(blocks, q, t), 0),
            )
        else:
            mine = None
        ok = (ref is None) == (mine is None)
        if ok and ref is not None:
            # Global alignments report qPos/tPos = 0 with a free leading
            # gap; block starts aren't comparable — ends and score are
            keys = ("qs", "qe", "ts", "te", "score") if local else (
                "qe", "te", "score")
            ok = all(ref[k] == mine[k] for k in keys)
        tag = "OK " if ok else "DIFF"
        if not ok:
            n_bad += 1
            print(f"[{tag}] case {case} kind {kind}: ref={ref} mine={mine}")
        else:
            print(f"[{tag}] case {case} kind {kind}: {ref}")
    print(f"{n - n_bad}/{n} matching")


if __name__ == "__main__":
    main()
