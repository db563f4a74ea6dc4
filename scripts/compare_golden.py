#!/usr/bin/env python
"""Golden-output comparison: blasr_jax m4 vs reference blasrmc m4.

Usage: python scripts/compare_golden.py ours.m4 reference.m4

The reference appends /0_<len> subread suffixes to FASTA titles; names are
normalized before matching. Agreement = same contig+strand and interval
overlap >= 90% reciprocal.
"""

import sys


def parse_m4(path, strip_subread):
    out = {}
    for line in open(path):
        f = line.split()
        if len(f) < 13:
            continue
        name = f[0]
        if strip_subread and name.count("/") >= 1:
            # reference title suffix: <name>/0_<len>
            base, _, tail = name.rpartition("/")
            if "_" in tail:
                name = base
        rec = {
            "tname": f[1], "score": int(f[2]), "pct": float(f[3]),
            "qstart": int(f[5]), "qend": int(f[6]),
            "tstrand": int(f[8]), "tstart": int(f[9]), "tend": int(f[10]),
            "tlen": int(f[11]), "mapqv": int(f[12]),
        }
        if name not in out or rec["score"] < out[name]["score"]:
            out[name] = rec
    return out


def parse_m4_all(path, strip_subread):
    """All records per read (for -bestn N set comparison)."""
    out = {}
    for line in open(path):
        f = line.split()
        if len(f) < 13:
            continue
        name = f[0]
        if strip_subread and name.count("/") >= 1:
            base, _, tail = name.rpartition("/")
            if "_" in tail:
                name = base
        out.setdefault(name, []).append(
            (f[1], int(f[8]), int(f[9]), int(f[10]))
        )
    return out


def compare_sets(ours_path, ref_path):
    """-bestn>1 mode: per-read set equality of (tname, strand, locus)
    placements with 90% reciprocal-overlap matching."""
    ours = parse_m4_all(ours_path, True)
    ref = parse_m4_all(ref_path, True)
    common = set(ours) & set(ref)
    equal = sub = sup = diff = 0
    for n in sorted(common):
        a, b = ours[n], ref[n]

        def match(x, y):
            if x[0] != y[0] or x[1] != y[1]:
                return False
            lo, hi = max(x[2], y[2]), min(x[3], y[3])
            return (hi - lo) / max(x[3] - x[2], y[3] - y[2], 1) >= 0.9

        a_in_b = all(any(match(x, y) for y in b) for x in a)
        b_in_a = all(any(match(y, x) for x in a) for y in b)
        if a_in_b and b_in_a:
            equal += 1
        elif a_in_b:
            sub += 1
        elif b_in_a:
            sup += 1
        else:
            diff += 1
    n = len(common)
    print(f"common reads: {n}")
    print(
        f"placement sets: equal {equal} ({100.0*equal/max(n,1):.1f}%)  "
        f"ours-subset {sub}  ours-superset {sup}  divergent {diff}"
    )


def main():
    if sys.argv[1] == "-sets":
        compare_sets(sys.argv[2], sys.argv[3])
        return
    # both sides now emit the reference /0_<len> whole-read suffix
    ours = parse_m4(sys.argv[1], strip_subread=True)
    ref = parse_m4(sys.argv[2], strip_subread=True)
    common = set(ours) & set(ref)
    only_ours = len(set(ours) - set(ref))
    only_ref = len(set(ref) - set(ours))
    agree = strand_bad = locus_bad = 0
    score_deltas = []
    mapq_close = mapq_total = 0
    divergent = []
    for n in sorted(common):
        a, b = ours[n], ref[n]
        if a["tname"] != b["tname"] or a["tstrand"] != b["tstrand"]:
            strand_bad += 1
            divergent.append(n)
            continue
        lo = max(a["tstart"], b["tstart"])
        hi = min(a["tend"], b["tend"])
        inter = max(0, hi - lo)
        denom = max(a["tend"] - a["tstart"], b["tend"] - b["tstart"], 1)
        if inter / denom >= 0.9:
            agree += 1
            score_deltas.append(a["score"] - b["score"])
            mapq_total += 1
            if abs(a["mapqv"] - b["mapqv"]) <= 1:
                mapq_close += 1
        else:
            locus_bad += 1
            divergent.append(n)
    n = len(common)
    print(f"common reads: {n}  ours-only: {only_ours}  ref-only: {only_ref}")
    print(f"locus+strand agreement: {agree}/{n} = {100.0 * agree / max(n,1):.2f}%")
    print(f"strand/contig mismatch: {strand_bad}  locus mismatch: {locus_bad}")
    if score_deltas:
        import statistics

        print(
            f"score delta (ours - ref): mean {statistics.mean(score_deltas):.1f} "
            f"median {statistics.median(score_deltas):.1f} "
            f"(negative = ours better under min-score)"
        )
    if mapq_total:
        print(
            f"mapQV within +-1 on agreeing reads: {mapq_close}/{mapq_total} "
            f"= {100.0 * mapq_close / mapq_total:.2f}%"
        )
    ledger_path = None
    if "--ledger" in sys.argv:
        ledger_path = sys.argv[sys.argv.index("--ledger") + 1]
    if "--names" in sys.argv:
        for n in divergent:
            print("DIVERGENT", n, "ours:", ours[n], "ref:", ref[n])
    if ledger_path:
        # frozen-divergence enforcement (round-5 ledger, VERDICT item 6):
        # every divergent read must be sanctioned in the ledger file
        # (lines starting with 'read '); new divergences fail the check
        sanctioned = set()
        for line in open(ledger_path):
            if line.startswith("read "):
                sanctioned.add(line.split()[1])
        new = [n for n in divergent if n not in sanctioned]
        gone = sorted(sanctioned - set(divergent))
        if gone:
            print(f"ledger: {len(gone)} sanctioned divergences now AGREE "
                  f"(update the ledger): {gone}")
        if new:
            print(f"LEDGER VIOLATION: {len(new)} unsanctioned divergences: "
                  f"{new}")
            sys.exit(1)
        print(f"ledger: all {len(divergent)} divergences sanctioned")


if __name__ == "__main__":
    main()
