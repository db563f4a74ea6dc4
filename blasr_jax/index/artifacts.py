"""Device-ready genome index (L2).

Replaces the reference's trio of index artifacts — ``.sa`` suffix array with
prefix lookup table (SuffixArray.h:193,505), ``.bwt`` FM-index (BWT.h) and
``.ctab`` k-mer counts (TupleCountTable.h) — with one bundle designed for
device-memory residency:

  * ``genome``    uint8 [G]    codes 0..4 (N=4), concatenated contigs
  * ``sa``        int32/int64 [G]  suffix array over the N->A projected genome
  * ``sa_kmers``  int32 [G]    packed k-mer (k = min_match_length) starting at
                               each suffix, in SA order — an ascending array,
                               so anchoring = pure binary search over it
                               (this plays the role of both the prefix lookup
                               table and the tuple count table: interval width
                               IS the genome-wide k-mer frequency)
  * ``pos_ok``    bool  [G]    genome position t can seed an anchor (window
                               [t, t+k) has no N and stays inside one contig)

All positions are 64-bit on disk; cast to int32 for the device when G < 2^31.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from blasr_jax.core.encode import pack_kmers
from blasr_jax.index.suffix_array import build_suffix_array
from blasr_jax.io.seqdb import SeqDB, load_genome

INDEX_SUFFIX = ".btidx.npz"
INDEX_VERSION = 1


LUT_BITS = 22  # key-prefix lookup table width (role of the reference SA
               # prefix lookup table, SuffixArray.h:193 BuildLookupTable)


@dataclasses.dataclass
class GenomeIndex:
    genome: np.ndarray     # uint8 [G]
    sa: np.ndarray         # int [G]
    sa_kmers: np.ndarray   # int32 [G], ascending
    pos_ok: np.ndarray     # bool [G]
    k: int                 # k-mer length of sa_kmers
    seqdb: SeqDB

    def lut(self) -> tuple[np.ndarray, int, int]:
        """(lut, shift, max_steps): lut[p] = first SA row whose key prefix
        >= p; shift maps DEVICE keys to prefixes (for wide keys the device
        holds the top-30-bit half, so the shift is within that half);
        max_steps bounds the remaining in-bucket binary search."""
        wide = 2 * self.k > 31
        hi_bits = 30 if wide else 2 * self.k
        bits = min(LUT_BITS, hi_bits)
        host_shift = 2 * self.k - bits
        pref = (self.sa_kmers.astype(np.int64) >> host_shift)
        lut = np.searchsorted(pref, np.arange((1 << bits) + 1)).astype(np.int32)
        biggest = int(np.max(np.diff(lut))) if len(lut) > 1 else len(pref)
        max_steps = max(1, int(np.ceil(np.log2(biggest + 1))))
        shift = hi_bits - bits   # applied to the device-side (hi) keys
        return lut, shift, max_steps

    @property
    def genome_length(self) -> int:
        return int(self.genome.shape[0])

    def save(self, path: str, compress: bool = True) -> None:
        # sharded caches save uncompressed: a 200 Mb shard's zlib decompress
        # costs ~a minute per serve-time load, dwarfing the disk read
        savez = np.savez_compressed if compress else np.savez
        savez(
            path,
            version=np.int64(INDEX_VERSION),
            genome=self.genome,
            sa=self.sa.astype(np.int64),
            sa_kmers=self.sa_kmers,
            pos_ok=self.pos_ok,
            k=np.int64(self.k),
            names=np.asarray(self.seqdb.names, dtype=object),
            starts=self.seqdb.starts,
            md5s=np.asarray(self.seqdb.md5s, dtype=object),
        )

    @staticmethod
    def load(path: str) -> "GenomeIndex":
        z = np.load(path, allow_pickle=True)
        seqdb = SeqDB(list(z["names"]), z["starts"], list(z["md5s"]))
        sa = z["sa"]
        if len(sa) < 2**31:
            sa = sa.astype(np.int32)
        return GenomeIndex(z["genome"], sa, z["sa_kmers"], z["pos_ok"], int(z["k"]), seqdb)


def build_pos_ok(genome: np.ndarray, seqdb: SeqDB, k: int) -> np.ndarray:
    """Seed-validity mask: window [t, t+k) has no N and stays inside one
    contig (shared by the SA and FM index builds)."""
    from blasr_jax.core.encode import pack_kmers as _pk

    _, valid = _pk(genome, k)
    pos_ok = valid.copy()
    for s in seqdb.starts[1:-1]:
        pos_ok[max(0, int(s) - (k - 1)) : int(s)] = False
    return pos_ok


def build_index_from_arrays(genome: np.ndarray, seqdb: SeqDB, k: int) -> GenomeIndex:
    """Build the index from an in-memory concatenated genome."""
    if not (1 <= k <= 30):
        # keys pack 2 bits/base: int32 up to k=15, int64 (split hi/lo on
        # device) up to k=30
        raise ValueError(f"k={k}: anchor k-mer length must be in [1, 30]")
    g = int(len(genome))
    # SA over the N->A projection so that 2-bit packed keys are SA-ordered.
    proj = (genome & 3).astype(np.uint8)
    sa = build_suffix_array(proj)
    keys, valid = pack_kmers(genome, k)  # valid == no-N window fully inside
    sa_kmers = keys[sa].astype(np.int32 if 2 * k <= 31 else np.int64)
    pos_ok = build_pos_ok(genome, seqdb, k)
    if len(sa) < 2**31:
        sa = sa.astype(np.int32)
    return GenomeIndex(genome.astype(np.uint8), sa, sa_kmers, pos_ok, k, seqdb)


def build_index(genome_path: str, k: int = 14) -> GenomeIndex:
    genome, seqdb = load_genome(genome_path)
    return build_index_from_arrays(genome, seqdb, k)


def build_index_from_sa(genome_path: str, sa_path: str, k: int = 14) -> GenomeIndex:
    """Build the device bundle around a precomputed reference-format ``.sa``
    file (blasr ``-sa`` flag role, Blasr.cpp:4375-4449 index discovery)."""
    from blasr_jax.index.safile import read_sa_file

    genome, seqdb = load_genome(genome_path)
    sa = read_sa_file(sa_path, genome_len=len(genome))
    if len(sa) != len(genome):
        raise ValueError(
            f"{sa_path}: suffix array length {len(sa)} != genome {len(genome)}"
        )
    keys, _ = pack_kmers(genome, k)
    kv = keys[sa]
    if np.any(np.diff(kv) < 0):
        # reference order interleaves short suffixes (its end-of-string
        # sorts LARGEST, safile.reference_order_sa); our pipeline only
        # needs ascending k-keys, so stable-resort those ties
        order = np.argsort(kv, kind="stable")
        sa = sa[order]
        kv = kv[order]
        if np.any(np.diff(kv) < 0):
            raise ValueError(
                f"{sa_path}: array is not a suffix order of {genome_path}"
            )
    sa_kmers = kv.astype(np.int32 if 2 * k <= 31 else np.int64)
    pos_ok = build_pos_ok(genome, seqdb, k)
    if len(sa) < 2**31:
        sa = sa.astype(np.int32)
    return GenomeIndex(genome.astype(np.uint8), sa, sa_kmers, pos_ok, k, seqdb)


def load_index(genome_path: str, k: int = 14, cache: bool = True) -> GenomeIndex:
    """Load (or build and cache) the index for a genome FASTA.

    Mirrors the reference's index auto-discovery (Blasr.cpp:4375-4449:
    use genome.bwt if present, else genome.sa, else build on the fly).
    """
    idx_path = genome_path + INDEX_SUFFIX
    if cache and os.path.exists(idx_path) and os.path.getmtime(idx_path) >= os.path.getmtime(genome_path):
        idx = GenomeIndex.load(idx_path)
        if idx.k == k:
            return idx
    idx = build_index(genome_path, k=k)
    if cache:
        try:
            idx.save(idx_path)
        except OSError:
            pass
    return idx


def build_count_table(genome: np.ndarray, k: int = 8) -> np.ndarray:
    """Dense 4^k genome k-mer count table.

    Role of reference ``TupleCountTable`` (datastructures/tuplelists/
    TupleCountTable.h:11-90, built on the fly at Blasr.cpp:4479-4483): the
    background k-mer frequency model behind anchor p-values. The mapping
    pipeline gets the same information from SA-interval widths at the full
    anchor length; this dense table serves the satellite tools and the
    explicit-ctab workflow.
    """
    keys, valid = pack_kmers(genome, k)
    return np.bincount(keys[valid].astype(np.int64), minlength=4**k).astype(
        np.int32
    )
