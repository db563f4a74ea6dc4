"""bwtutils: FM-index satellite tools (L8).

Roles of the reference bwtutils/ executables (bwtutils/Makefile:25-38):

  sa2bwt     SuffixArrayToBWT.cpp — genome (+ SA) -> FM-index bundle
  bwtquery   BWTQuery.cpp         — count+locate a query string
  bwtinfo    bwtswPrint/bwtpbPrint role — dump index stats

Usage: python -m blasr_jax.cli.bwtutils <command> [args]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

FM_SUFFIX = ".btfm.npz"


def _cmd_sa2bwt(argv) -> int:
    p = argparse.ArgumentParser(prog="bwtutils sa2bwt")
    p.add_argument("genome", help="genome FASTA")
    p.add_argument("out", nargs="?", default=None,
                   help="output FM bundle (default <genome>.btfm.npz)")
    args = p.parse_args(argv)

    from blasr_jax.index.fm import build_fm_index
    from blasr_jax.index.suffix_array import build_suffix_array
    from blasr_jax.io.seqdb import load_genome

    genome, seqdb = load_genome(args.genome)
    t0 = time.time()
    sa = build_suffix_array(genome)  # raw codes incl. N (FM alphabet)
    fm = build_fm_index(genome, sa)
    out = args.out or (args.genome + FM_SUFFIX)
    fm.save(out)
    print(
        f"wrote {out}: {fm.genome_length} bases "
        f"({fm.bwt_rows.nbytes + fm.occ_bins.nbytes + fm.ssa_vals.nbytes} index "
        f"bytes), built in {time.time() - t0:.2f}s",
        file=sys.stderr,
    )
    return 0


def _cmd_bwtquery(argv) -> int:
    p = argparse.ArgumentParser(prog="bwtutils bwtquery")
    p.add_argument("fm", help="FM bundle (.btfm.npz)")
    p.add_argument("query", help="query string (ACGT)")
    p.add_argument("-max", type=int, default=20, help="max positions printed")
    args = p.parse_args(argv)

    from blasr_jax.core.encode import seq_to_codes
    from blasr_jax.index.fm import FMIndex, count_host, locate_host

    fm = FMIndex.load(args.fm)
    pat = seq_to_codes(args.query.encode())
    lo, hi = count_host(fm, pat)
    print(f"{args.query}: {hi - lo} occurrence(s)")
    for r in range(lo, min(hi, lo + args.max)):
        print(locate_host(fm, r))
    return 0


def _cmd_bwtinfo(argv) -> int:
    p = argparse.ArgumentParser(prog="bwtutils bwtinfo")
    p.add_argument("fm")
    args = p.parse_args(argv)

    from blasr_jax.index.fm import FMIndex

    fm = FMIndex.load(args.fm)
    base_counts = {c: int(v) for c, v in zip("ACGTN$", np.bincount(
        fm.bwt_rows.reshape(-1)[fm.bwt_rows.reshape(-1) < 6], minlength=6))}
    print(f"rows: {fm.n}  genome: {fm.genome_length}")
    print(f"char counts: {base_counts}")
    print(f"sampled SA entries: {len(fm.ssa_vals)} (stride 8)")
    tot = fm.bwt_rows.nbytes + fm.occ_bins.nbytes + fm.ssa_vals.nbytes + \
        fm.ssa_mask.nbytes + fm.ssa_base.nbytes
    print(f"index bytes: {tot} ({tot / max(fm.genome_length, 1):.2f} B/base)")
    return 0


def _cmd_bwt2sa(argv) -> int:
    """Reconstruct the suffix array (and genome) from an FM bundle and write
    a reference-format .sa file (role of bwtutils/BwtToSuffixArray.cpp:24-28,
    which emits Locate(row) per BWT row). The framework's row order is
    $-first (standard), vs the reference's terminator-highest order — prefix
    ties between a suffix and its extensions land in opposite relative
    order; both are valid .sa files for their producer's search."""
    p = argparse.ArgumentParser(prog="bwtutils bwt2sa")
    p.add_argument("fm", help="FM bundle (.btfm.npz)")
    p.add_argument("out", help="output .sa (reference binary format)")
    args = p.parse_args(argv)

    from blasr_jax.index.fm import FMIndex, fm_reconstruct
    from blasr_jax.index.safile import write_sa_file

    fm = FMIndex.load(args.fm)
    t0 = time.time()
    genome, sa_full = fm_reconstruct(fm)
    # reference bwt2sa writes G rows (no sentinel row)
    write_sa_file(args.out, sa_full[1:], genome)
    print(
        f"wrote {args.out}: {len(sa_full) - 1} rows reconstructed from the "
        f"BWT in {time.time() - t0:.2f}s", file=sys.stderr,
    )
    return 0


def _cmd_locatelist(argv) -> int:
    """Count/locate every sequence of a FASTA query file
    (role of bwtutils/BWTLocateList.cpp:14-70)."""
    p = argparse.ArgumentParser(prog="bwtutils locatelist")
    p.add_argument("fm", help="FM bundle (.btfm.npz)")
    p.add_argument("queries", help="FASTA of query sequences")
    p.add_argument("-max", type=int, default=0, help="max positions per query")
    p.add_argument("-count", action="store_true", help="count only")
    p.add_argument("-print", dest="do_print", action="store_true",
                   help="print positions")
    args = p.parse_args(argv)

    from blasr_jax.index.fm import FMIndex, count_host, locate_host
    from blasr_jax.io.batching import read_records

    fm = FMIndex.load(args.fm)
    for r in read_records(args.queries):
        lo, hi = count_host(fm, r.codes)
        print(f"{r.name} {hi - lo}")
        if args.do_print and not args.count:
            cap = hi if args.max == 0 else min(hi, lo + args.max)
            pos = sorted(locate_host(fm, row) for row in range(lo, cap))
            for v in pos:
                print(v)
    return 0


COMMANDS = {
    "sa2bwt": _cmd_sa2bwt,
    "bwtquery": _cmd_bwtquery,
    "bwtinfo": _cmd_bwtinfo,
    "bwt2sa": _cmd_bwt2sa,
    "locatelist": _cmd_locatelist,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(
            f"usage: python -m blasr_jax.cli.bwtutils {{{','.join(COMMANDS)}}} ...",
            file=sys.stderr,
        )
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
