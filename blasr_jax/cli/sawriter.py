"""sawriter-jax: build and store the genome index (L2 satellite).

Role of reference ``alignment/SAWriter.cpp`` (sawritermc): build the suffix
array (+ prefix lookup structures) for a genome once and reuse it. The
bundle (.btidx.npz) holds the SA, the SA-ordered packed k-mer keys (which
subsume both the prefix lookup table and the TupleCountTable — interval
width IS the k-mer count), seeding validity mask, and the contig database.

Unlike the reference (4 Gb rejection at SAWriter.cpp:176-181), positions
switch to 64-bit automatically for large genomes.

Usage: python -m blasr_jax.cli.sawriter genome.fasta [out.btidx.npz] [-k 14]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sawriter-jax")
    p.add_argument("genome", help="genome FASTA")
    p.add_argument("out", nargs="?", default=None,
                   help="output index path (default <genome>.btidx.npz)")
    p.add_argument("-k", "-kmer", dest="k", type=int, default=14,
                   help="anchor k-mer length (1..15)")
    p.add_argument("-safile", action="store_true",
                   help="also write reference-format <genome>.sa "
                        "(SuffixArray.h binary layout, magic 0xacac0001; "
                        "loadable by reference blasr -sa)")
    p.add_argument("-salut", type=int, default=0, metavar="PREFIXLEN",
                   help="include the prefix lookup table in the .sa file")
    args = p.parse_args(argv)

    from blasr_jax.index.artifacts import INDEX_SUFFIX, build_index

    out = args.out or (args.genome + INDEX_SUFFIX)
    t0 = time.time()
    idx = build_index(args.genome, k=args.k)
    t_build = time.time() - t0
    idx.save(out)
    print(
        f"wrote {out}: {idx.genome_length} bases, {len(idx.seqdb.names)} contigs, "
        f"k={idx.k}, built in {t_build:.2f}s",
        file=sys.stderr,
    )
    if args.safile:
        from blasr_jax.index.safile import reference_order_sa, write_sa_file

        sa_path = args.genome + ".sa"
        write_sa_file(sa_path, reference_order_sa(idx.genome),
                      genome=idx.genome, lookup_prefix_len=args.salut)
        print(f"wrote {sa_path} (reference .sa format)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
