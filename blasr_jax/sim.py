"""Read simulator (L8 satellite: role of reference ``simulator/alchemy`` +
``sequtils/Evolve.cpp`` + ``simpleShredder``).

Generates synthetic genomes and PacBio-like noisy reads with known true
positions encoded in the read title (the reference's ``-posMap``/title
convention ``>read_index|chr|start|end``), so mapping accuracy can be scored
without real data.
"""

from __future__ import annotations

import numpy as np

from blasr_jax.core.encode import revcomp_codes
from blasr_jax.io.batching import Read


def simulate_genome(length: int, seed: int = 0, repeat_fraction: float = 0.05) -> np.ndarray:
    """Random genome with a sprinkling of duplicated blocks (repeats)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, length).astype(np.uint8)
    n_rep = int(length * repeat_fraction) // 2000
    for _ in range(max(0, n_rep)):
        src = int(rng.integers(0, length - 2000))
        dst = int(rng.integers(0, length - 2000))
        g[dst : dst + 2000] = g[src : src + 2000]
    return g


def simulate_reads(
    genome: np.ndarray,
    n_reads: int,
    mean_len: int = 1000,
    min_len: int = 200,
    seed: int = 1,
    sub_rate: float = 0.01,
    ins_rate: float = 0.08,
    del_rate: float = 0.04,
) -> tuple[list[Read], list[tuple[int, int, int]]]:
    """Sample noisy reads; returns (reads, truth=(start, end, strand))."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    reads: list[Read] = []
    truth: list[tuple[int, int, int]] = []
    for i in range(n_reads):
        length = int(np.clip(rng.exponential(mean_len * 0.35) + mean_len * 0.65, min_len, mean_len * 3))
        length = min(length, G - 1)
        start = int(rng.integers(0, G - length))
        end = start + length
        # sample errors vectorized: per-position event
        seg = genome[start:end]
        r = rng.random(length)
        keep = r >= del_rate
        seg = seg[keep]
        r2 = rng.random(len(seg))
        subs = r2 < sub_rate
        seg = np.where(subs, (seg + rng.integers(1, 4, len(seg))) % 4, seg).astype(np.uint8)
        n_ins = rng.binomial(len(seg), ins_rate)
        if n_ins:
            pos = np.sort(rng.integers(0, len(seg) + 1, n_ins))
            ins = rng.integers(0, 4, n_ins).astype(np.uint8)
            seg = np.insert(seg, pos, ins)
        strand = int(rng.integers(0, 2))
        if strand:
            seg = revcomp_codes(seg)
        name = f"sim/{i}|ref|{start}|{end}|{strand}"
        reads.append(Read(name, seg, None, i))
        truth.append((start, end, strand))
    return reads, truth


def parse_truth(name: str) -> tuple[int, int, int]:
    """Decode (start, end, strand) from a simulated read title."""
    parts = name.split("|")
    return int(parts[2]), int(parts[3]), int(parts[4])


def shred_genome(
    genome: np.ndarray,
    seqdb,
    read_length: int,
    coverage: float = 1.0,
    seed: int = 0,
) -> list[tuple[str, np.ndarray]]:
    """Shred a genome into error-free reads (role of sequtils simpleShredder).

    Tiles each contig with reads of ``read_length``; coverage > 1 adds
    additional randomly-offset passes.
    """
    rng = np.random.default_rng(seed)
    out: list[tuple[str, np.ndarray]] = []
    starts = seqdb.starts
    idx = 0
    n_pass = max(1, int(np.ceil(coverage)))
    for ci, name in enumerate(seqdb.names):
        lo, hi = int(starts[ci]), int(starts[ci + 1])
        for p in range(n_pass):
            ofs = 0 if p == 0 else int(rng.integers(0, read_length))
            for s in range(lo + ofs, hi, read_length):
                e = min(s + read_length, hi)
                if e - s < read_length // 4:
                    continue
                out.append((f"shred/{idx}|{name}|{s - lo}|{e - lo}|0",
                            genome[s:e].copy()))
                idx += 1
    return out


def evolve_sequence(
    codes: np.ndarray,
    sub_rate: float,
    ins_rate: float,
    del_rate: float,
    seed: int = 0,
) -> tuple[np.ndarray, dict]:
    """Mutate a sequence (role of sequtils/Evolve.cpp): substitutions,
    insertions and deletions at the given per-base rates. Returns the
    mutated sequence and mutation counts."""
    rng = np.random.default_rng(seed)
    n = len(codes)
    r = rng.random(n)
    keep = r >= del_rate
    seg = codes[keep]
    r2 = rng.random(len(seg))
    subs = (r2 < sub_rate) & (seg < 4)
    seg = np.where(
        subs, (seg + rng.integers(1, 4, len(seg))) % 4, seg
    ).astype(np.uint8)
    n_ins = rng.binomial(len(seg), ins_rate)
    if n_ins:
        pos = np.sort(rng.integers(0, len(seg) + 1, n_ins))
        ins = rng.integers(0, 4, n_ins).astype(np.uint8)
        seg = np.insert(seg, pos, ins)
    stats = {
        "n_sub": int(subs.sum()),
        "n_del": int(n - keep.sum()),
        "n_ins": int(n_ins),
    }
    return seg, stats


# ---- alchemy-style simulation (context-conditioned error model) ----------
#
# Role of reference ``simulator/Alchemy.cpp`` (read simulator driven by an
# empirical length histogram + per-context error/quality samples) and
# ``simulator/StoreQualityByContext.cpp`` (build that model from real
# alignments). The model here conditions (sub, ins, del) rates and emitted
# quality values on the preceding base context, and can be estimated from
# any SAM file produced by this framework or the reference.

import dataclasses as _dc
import json as _json


@_dc.dataclass
class ErrorModel:
    """Context-conditioned error model. Context = previous base (4) and
    current base (4) -> 16 contexts."""

    lengths: list          # histogram support (read lengths)
    length_probs: list     # histogram probabilities
    sub: list              # (16,) substitution rate per context
    ins: list              # (16,) insertion rate per context
    dele: list             # (16,) deletion rate per context
    mean_qual: float = 15.0
    ins_cognate: float = 0.0  # P(inserted base copies the previous base)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            _json.dump(_dc.asdict(self), f)

    @staticmethod
    def load(path: str) -> "ErrorModel":
        with open(path) as f:
            return ErrorModel(**_json.load(f))

    @staticmethod
    def default() -> "ErrorModel":
        """PacBio-like defaults (12% ins, 2% del, 1% sub, 1-8 kb reads)."""
        lengths = [500, 1000, 2000, 4000, 8000]
        probs = [0.15, 0.35, 0.3, 0.15, 0.05]
        return ErrorModel(
            lengths=lengths,
            length_probs=probs,
            sub=[0.01] * 16,
            ins=[0.10] * 16,
            dele=[0.03] * 16,
        )

    @staticmethod
    def published_clr() -> "ErrorModel":
        """Error model built from PUBLISHED PacBio CLR statistics, not from
        anything this repo's pipeline was tuned on (simulator-closed-loop
        guard). Rates follow the BLASR paper's own characterization of
        C1-chemistry continuous-long-read data (Chaisson & Tesler 2012,
        BMC Bioinformatics 13:238: ~11% insertion, ~3.4% deletion, ~1.4%
        substitution; the same regime the reference's empirical alchemy
        models target, reference simulator/Alchemy.cpp:43+), with the two
        context effects the primary literature documents:

        - cognate ("stutter") insertions: the inserted base duplicates its
          neighbour far more often than chance (~60% of insertions), and
          insertion probability is elevated when prev==cur;
        - homopolymer deletions: deletion probability is elevated inside
          homopolymer runs (prev==cur contexts).

        Context encoding is (prev << 2) | cur. Averages over a uniform
        base composition reproduce the published totals: ins avg 0.11
        (cognate contexts x2), del avg 0.034 (homopolymer x1.8), sub 0.014
        uniform.
        """
        cognate = [(p << 2) | p for p in range(4)]
        ins = [0.088] * 16
        dele = [0.02833] * 16
        for c in cognate:
            ins[c] = 0.176
            dele[c] = 0.051
        return ErrorModel(
            lengths=[500, 1000, 1500, 2000, 2500, 3000],
            length_probs=[0.25, 0.30, 0.20, 0.12, 0.08, 0.05],
            sub=[0.014] * 16,
            ins=ins,
            dele=dele,
            mean_qual=10.0,   # CLR-era raw base QV regime
            ins_cognate=0.6,
        )


def build_model_from_sam(sam_path: str, bins: int = 8) -> ErrorModel:
    """Estimate an ErrorModel from aligned reads (StoreQualityByContext
    role): per-context rates from CIGAR op counts, length histogram from
    read lengths."""
    from blasr_jax.io.sam import read_sam

    sam = read_sam(sam_path)
    ctx_ops = np.zeros((16, 3), np.int64)  # sub-proxy, ins, del per context
    ctx_m = np.zeros(16, np.int64)
    lengths = []
    quals = []
    for rec in sam.records:
        if rec.is_unmapped or rec.seq == "*":
            continue
        codes = seq_to_codes_safe(rec.seq)
        lengths.append(len(codes))
        if rec.qual is not None:
            quals.append(float(np.mean(rec.qual)))
        qpos = 0
        prev = 0
        nm = int(rec.tags.get("NM", 0))
        n_m = 0
        for op, ln in rec.cigar_runs():
            if op in "SH":
                qpos += ln if op == "S" else 0
                continue
            if op in "M=X":
                for j in range(ln):
                    c = int(codes[min(qpos + j, len(codes) - 1)])
                    ctx = (prev << 2) | (c & 3)
                    ctx_m[ctx] += 1
                    prev = c & 3
                n_m += ln
                qpos += ln
            elif op == "I":
                c = int(codes[min(qpos, len(codes) - 1)])
                ctx = (prev << 2) | (c & 3)
                ctx_ops[ctx, 1] += ln
                qpos += ln
            elif op in "DN":
                ctx = prev << 2
                ctx_ops[ctx, 2] += ln
        # spread NM mismatches uniformly over contexts weighted by matches
        if n_m:
            frac = ctx_m / max(ctx_m.sum(), 1)
            ctx_ops[:, 0] += (nm * frac).astype(np.int64)
    tot = np.maximum(ctx_m + ctx_ops.sum(axis=1), 1)
    hist, edges = np.histogram(lengths, bins=bins)
    mids = ((edges[:-1] + edges[1:]) / 2).astype(int).tolist()
    probs = (hist / max(hist.sum(), 1)).tolist()
    return ErrorModel(
        lengths=mids,
        length_probs=probs,
        sub=(ctx_ops[:, 0] / tot).tolist(),
        ins=(ctx_ops[:, 1] / tot).tolist(),
        dele=(ctx_ops[:, 2] / tot).tolist(),
        mean_qual=float(np.mean(quals)) if quals else 15.0,
    )


def seq_to_codes_safe(seq: str) -> np.ndarray:
    from blasr_jax.core.encode import seq_to_codes

    return seq_to_codes(seq.encode())


def simulate_reads_alchemy(
    genome: np.ndarray,
    model: ErrorModel,
    n_reads: int,
    seed: int = 0,
) -> tuple[list[Read], list[tuple[int, int, int]]]:
    """Sample reads per the alchemy recipe: length from the histogram,
    position uniform, context-conditioned errors, phred quals around the
    model mean (low at error sites)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    sub = np.asarray(model.sub)
    ins = np.asarray(model.ins)
    dele = np.asarray(model.dele)
    probs = np.asarray(model.length_probs, float)
    probs = probs / probs.sum()
    reads: list[Read] = []
    truth: list[tuple[int, int, int]] = []
    for i in range(n_reads):
        length = int(rng.choice(model.lengths, p=probs))
        length = max(100, min(length, G - 1))
        start = int(rng.integers(0, G - length))
        seg = genome[start : start + length]
        out = []
        qual = []
        prev = 0
        for c in seg:
            c = int(c)
            ctx = (prev << 2) | (c & 3)
            r = rng.random()
            if r < dele[ctx]:
                continue  # deletion
            if r < dele[ctx] + sub[ctx]:
                c2 = (c + int(rng.integers(1, 4))) % 4
                out.append(c2)
                qual.append(max(4, int(model.mean_qual) - 8))
                prev = c2
            else:
                out.append(c)
                qual.append(int(np.clip(rng.normal(model.mean_qual, 4), 4, 60)))
                prev = c & 3
            while rng.random() < ins[ctx]:
                if rng.random() < model.ins_cognate:
                    ci = prev          # cognate (stutter) insertion
                else:
                    ci = int(rng.integers(0, 4))
                out.append(ci)
                qual.append(max(4, int(model.mean_qual) - 10))
        strand = int(rng.integers(0, 2))
        codes = np.asarray(out, np.uint8)
        q = np.asarray(qual, np.uint8)
        if strand:
            codes = revcomp_codes(codes)
            q = q[::-1].copy()
        name = f"alchemy/{i}|ref|{start}|{start + length}|{strand}"
        reads.append(Read(name, codes, q, i))
        truth.append((start, start + length, strand))
    return reads, truth
