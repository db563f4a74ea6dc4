"""Smoke test of the mapping path on NVIDIA GPUs, through the user's entry
points, at the bench corpus's size (4.6 Mb genome, 2,000 CLR-like reads).

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: the dp mesh and the sharded
                                  # index, each against one card, only

One card, in one process:
  1. device   platform, device kind and count as JAX reports them, and the
              card's name and power limit; anything but a GPU fails
  2. dp       the CUDA banded DP against XLA's scan on the card, bit for
              bit, at I = 512 items, L = 1,024 and 3,328, W = 32/128/256,
              in every mode the mapper uses
  3. e2e      the CLI (-m 4; FASTQ -sam -clipping soft) on the bench corpus
              with the band-escalation retry: accuracy on the true locus
              >= 0.975, and the traced program holds the CUDA DP
  4. cpu      256 reads mapped on the CPU device (XLA path, own index)
              give the card's records
  5. info     reads/s, compile seconds, peak device memory
The last line of standard output is one JSON object; any failure exits
non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ACCURACY_MIN = 0.975  # bench.py's guard on accuracy_true_locus
# the bench operating point (bench.py), as CLI flags
BENCH_FLAGS = [
    "-batchSize", "256", "-maxReadLen", "3328", "-nCandidates", "4",
    "-dpCandidates", "2", "-anchorStride", "4", "-maxAnchorsPerRead", "128",
    "-bandSize", "16",
]


def log(*a):
    print(*a, flush=True)


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU, JAX found {d.platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    for line in smi:
        log(line)
    return devs, smi[0]


def _noisy_copy(rng, seg):
    """A CLR-like read of ``seg``: the BLASR paper's rates (11% insertion,
    3.4% deletion, 1.4% substitution), as sim.ErrorModel.published_clr."""
    s = seg[rng.random(len(seg)) >= 0.034]
    sub = rng.random(len(s)) < 0.014
    s = np.where(sub, (s + rng.integers(1, 4, len(s))) % 4, s).astype(np.uint8)
    n_ins = rng.binomial(len(s), 0.11)
    pos = np.sort(rng.integers(0, len(s) + 1, n_ins))
    return np.insert(s, pos, rng.integers(0, 4, n_ins).astype(np.uint8))


def _dp_inputs(rng, I, L, T, W, mode):
    import jax.numpy as jnp

    from blasr_jax.ops.banded_align import (
        QOFF_SHIFT, AlignScores, clamp_knots_to_shared, make_qoff,
        make_qoff_knots, make_qoff_num, qoff_from_knots,
    )

    S, diag = L + T - 1, (T - L) // 2
    Q = np.full((I, L), 4, np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    qlen = np.zeros(I, np.int32)
    for i in range(I):
        n = int(rng.integers(L // 2, (L - 100) / 1.1))
        q = _noisy_copy(rng, Tc[i, diag : diag + n])[:L]
        Q[i, : len(q)] = q
        qlen[i] = len(q)
    qoff = make_qoff_num(L, T, W, diag, round((1 << QOFF_SHIFT) / 1.92))
    qual = None
    scores = AlignScores()
    if "knots" in mode:
        aq = np.sort(rng.integers(0, L // 2, (I, 16)), axis=1).astype(np.int32)
        at = (aq * 0.92).astype(np.int32) + diag
        knots = make_qoff_knots(
            jnp.asarray(aq + at), jnp.asarray(aq - W // 2),
            jnp.ones((I, 16), bool), S, L, W, diag=diag,
            num=1 << (QOFF_SHIFT - 1),
        )
        shared = jnp.asarray(make_qoff(L, T, W, diag))
        qoff = qoff_from_knots(clamp_knots_to_shared(knots, shared, W), S)
    if "qual8" in mode:
        qual = jnp.asarray(rng.integers(3, 45, (I, L)).astype(np.uint8))
    if "qual16" in mode:
        qual = jnp.asarray(
            rng.integers(3, 45, (I, L)).astype(np.uint16)
            | (rng.integers(3, 45, (I, L)).astype(np.uint16) << 8)
        )
    if "matrix" in mode:
        scores = AlignScores(matrix=(
            -5, -2, 6, 6, 0, -2, -5, 6, 6, 0, 6, 6, -5, 6, 0,
            6, 6, 6, -5, 0, 0, 0, 0, 0, 0,
        ))
    args = (
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.zeros(I, jnp.int32), jnp.full(I, T, jnp.int32), qoff, qual,
    )
    return args, scores


def phase_dp(gpu) -> None:
    """CUDA kernel == XLA scan, on the card, every mode and width."""
    import jax
    import jax.numpy as jnp

    from blasr_jax.ops.banded_align import banded_align
    from blasr_jax.ops.banded_gpu import banded_align_gpu

    rng = np.random.default_rng(2024)
    I = 512
    for L in (1024, 3328):
        T = L + 256
        for W in (32, 128, 256):
            for mode in ("shared", "knots+qual8", "qual16+matrix"):
                with jax.default_device(gpu):
                    args, sc = _dp_inputs(rng, I, L, T, W, mode)
                    ref = banded_align(*args, scores=sc, with_traceback=True,
                                       band_width=W)
                    got = banded_align_gpu(*args, scores=sc, band_width=W)
                    same = {
                        f: bool(jnp.array_equal(getattr(ref, f), getattr(got, f)))
                        for f in ("score", "best_a", "best_w", "arrows")
                    }
                n_aln = int((np.asarray(ref.score) < 0).sum())
                log(f"dp: L={L} W={W} mode={mode} equal={same} aligned={n_aln}/{I}")
                if not all(same.values()) or n_aln < I // 2:
                    raise AssertionError(f"dp check failed at L={L} W={W} {mode}")
                del ref, got, args


def _truth_name(qname: str) -> str:
    base, _, tail = qname.rpartition("/")
    a, _, b = tail.partition("_")
    return base if base and a.isdigit() and b.isdigit() else qname


def _accuracy(best: dict, names: list) -> float:
    """bench.py's rule: strand right and both ends within 100 bases."""
    from blasr_jax.sim import parse_truth

    ok = 0
    for name in names:
        rec = best.get(name)
        if rec is None:
            continue
        start, end, strand = parse_truth(name)
        ok += rec[0] == strand and abs(rec[1] - start) < 100 and abs(rec[2] - end) < 100
    return ok / len(names)


def _best_m4(path: str) -> dict:
    best = {}
    for line in open(path):
        f = line.split()
        name, score, tstrand = _truth_name(f[0]), int(f[2]), int(f[8])
        ts, te, tlen = int(f[9]), int(f[10]), int(f[11])
        if tstrand == 1:
            ts, te = tlen - te, tlen - ts
        if name not in best or score < best[name][3]:
            best[name] = (tstrand, ts, te, score)
    return best


def _best_sam(path: str) -> dict:
    import re

    best = {}
    for line in open(path):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        flag = int(f[1])
        if flag & 0x904 or f[5] == "*":
            continue  # unmapped, secondary or supplementary
        span = sum(int(n) for n, op in re.findall(r"(\d+)([MDN=X])", f[5]))
        start = int(f[3]) - 1
        best[_truth_name(f[0])] = (int(bool(flag & 16)), start, start + span, 0)
    return best


def phase_e2e(workdir: str, card: str):
    import jax

    import bench
    from blasr_jax.cli.blasr import build_arg_parser, main as blasr_main
    from blasr_jax.cli.blasr import params_from_args
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.io.fastq import write_fastq
    from blasr_jax.pipeline import mapper as mapper_mod
    from blasr_jax.pipeline.runner import run_mapping

    bench.ensure_corpus()
    reads = read_records(bench.READS_FA)
    names = [r.name for r in reads]

    m4 = os.path.join(workdir, "out.m4")
    t0 = time.time()
    blasr_main([bench.READS_FA, bench.GENOME_FA, "-m", "4", "-out", m4] + BENCH_FLAGS)
    first_s = time.time() - t0
    acc_m4 = _accuracy(_best_m4(m4), names)
    log(f"e2e: -m 4 accuracy_true_locus={acc_m4:.4f} first_run_s={first_s:.1f}")

    rng = np.random.default_rng(31)
    fq = os.path.join(workdir, "reads.fastq")
    write_fastq(fq, [
        (r.name, r.codes, rng.integers(8, 40, len(r)).astype(np.uint8))
        for r in reads
    ])
    sam = os.path.join(workdir, "out.sam")
    blasr_main([fq, bench.GENOME_FA, "-sam", "-clipping", "soft", "-out", sam]
               + BENCH_FLAGS)
    acc_sam = _accuracy(_best_sam(sam), names)
    log(f"e2e: FASTQ -sam -clipping soft accuracy_true_locus={acc_sam:.4f}")
    for what, acc in (("-m 4", acc_m4), ("-sam", acc_sam)):
        if acc < ACCURACY_MIN:
            raise AssertionError(f"{what}: accuracy {acc:.4f} < {ACCURACY_MIN}")

    # the program the CLI ran: the CUDA DP is in it, no other custom call
    params = params_from_args(build_arg_parser().parse_args(
        [bench.READS_FA, bench.GENOME_FA, "-m", "4"] + BENCH_FLAGS))
    index = load_index(bench.GENOME_FA, k=params.min_match_length)
    mp = mapper_mod.Mapper(index, params)
    from blasr_jax.io.batching import batch_reads

    batch = next(iter(batch_reads(reads, params.batch_size, params.max_read_len)))
    di = mp.device_index
    hlo = mapper_mod._map_batch_wire.lower(
        batch.codes, batch.lengths, di.genome_pad, di.arrays, di.starts, None,
        params=params, pad=di.pad, k=di.k, genome_len=di.genome_len,
        dp=mp.dp, index_kind=di.kind, fm_n=di.fm_n, lut_meta=di.lut_meta,
        mesh=None,
    ).as_text()
    calls = sorted(set(
        part.split('"')[0].split("(")[0]
        for part in hlo.split("stablehlo.custom_call @")[1:]
    ))
    n_gather = hlo.count("stablehlo.gather")
    log(f"e2e: dp={mp.dp} custom_calls={calls} xla_gathers={n_gather}")
    if mp.dp != "cuda" or "blasr_banded_dp" not in calls:
        raise AssertionError("the mapping program does not run the CUDA DP")

    # steady state (everything compiled by the CLI run above)
    run_mapping(index, reads, params)
    t0 = time.time()
    run_mapping(index, reads, params)
    steady_s = time.time() - t0
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", -1)
    log(f"info: card={card} reads_per_s={len(reads) / steady_s:.1f} "
        f"steady_run_s={steady_s:.3f} first_cli_run_s={first_s:.1f} "
        f"setup_s={first_s - steady_s:.1f} (first CLI run minus a steady "
        f"run: compilation and index build) peak_bytes_in_use={peak}")
    return params, reads


def _rec_key(r):
    p = r.path
    return (r.qname, r.tname, r.score, r.pct_similarity, r.qstart, r.qend,
            r.tstrand, r.tstart, r.tend, r.mapqv,
            p.n_match, p.n_mismatch, p.n_ins, p.n_del)


def _compare(a, b, what: str) -> int:
    ka = {r.qname: _rec_key(r) for r in a}
    kb = {r.qname: _rec_key(r) for r in b}
    diff = sorted(n for n in set(ka) | set(kb) if ka.get(n) != kb.get(n))
    for n in diff:
        log(f"{what}: differs {n}: {ka.get(n)} vs {kb.get(n)}")
    log(f"{what}: {len(ka)} vs {len(kb)} records, {len(diff)} reads differ")
    return len(diff)


def phase_cpu(params, reads) -> None:
    """256 reads on the CPU device (XLA path, own GenomeIndex) == card."""
    import jax

    import bench
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.pipeline.runner import run_mapping

    sub = [r for r in reads if 768 < len(r) <= 1024][:256]
    out = {}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        index = load_index(bench.GENOME_FA, k=params.min_match_length)
        with jax.default_device(dev):
            out[dev.platform], _ = run_mapping(index, sub, params)
    if _compare(out["gpu"], out["cpu"], "cpu-vs-gpu"):
        raise AssertionError("CPU and GPU records differ")


def phase_four(devs) -> None:
    """-ndevices 4 (dp mesh) and the 4-way sharded index, each against the
    same reads mapped on one card."""
    import jax

    import bench
    from blasr_jax.cli.blasr import build_arg_parser, params_from_args
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.parallel.sharded import (
        build_or_load_shards, make_shards, run_mapping_sharded,
    )
    from blasr_jax.pipeline.runner import run_mapping

    bench.ensure_corpus()
    reads = [r for r in read_records(bench.READS_FA) if 768 < len(r) <= 1024][:512]
    args = [bench.READS_FA, bench.GENOME_FA, "-m", "4"] + BENCH_FLAGS
    p1 = params_from_args(build_arg_parser().parse_args(args))
    p4 = params_from_args(build_arg_parser().parse_args(args + ["-ndevices", "4"]))
    one, _ = run_mapping(load_index(bench.GENOME_FA, k=14), reads, p1)
    mesh_recs, _ = run_mapping(load_index(bench.GENOME_FA, k=14), reads, p4)
    n_mesh = _compare(mesh_recs, one, "mesh4-vs-one")

    index = load_index(bench.GENOME_FA, k=14)
    overlap = p1.max_read_len + p1.target_pad
    specs = make_shards(len(index.genome), 4, overlap)
    shards = build_or_load_shards(index.genome, index.seqdb, specs, 14, None, overlap)
    sharded, _ = run_mapping_sharded(
        index.genome, index.seqdb, reads, p1, n_shards=4, k=14,
        devices=devs[:4], shard_indexes=shards,
    )
    homes = [
        {d for _, di in s._device_index_cache.values() for d in di.genome_pad.devices()}
        for s in shards
    ]
    log(f"sharded: shard devices {[sorted(str(d) for d in h) for h in homes]}")
    if homes != [{devs[s]} for s in range(4)]:
        raise AssertionError("a shard's index is not on its own card")
    best = {}
    for r in sharded:
        if r.qname not in best or r.score < best[r.qname].score:
            best[r.qname] = r
    place = {}
    for r in one:
        if r.qname not in place or r.score < place[r.qname][2]:
            place[r.qname] = (r.tstrand, r.tstart_fwd, r.score)
    ties, bad = [], []
    for n, pl in sorted(place.items()):
        got = best.get(n)
        got = got and (got.tstrand, got.tstart_fwd, got.score)
        if got != pl:
            # equal scores at two loci: a repeat, ranked by the merge
            (ties if got and got[2] == pl[2] else bad).append((n, pl, got))
    log(f"sharded-vs-one: {len(place)} placements, {len(bad)} differ, "
        f"{len(ties)} equal-score repeat ties placed elsewhere {ties[:5]} {bad[:5]}")
    if n_mesh or bad:
        raise AssertionError("multi-card records differ from one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (dp mesh, sharded index)")
    opts = ap.parse_args()
    n_cards = 4 if opts.four else 1
    devs, card = phase_device(n_cards)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t0 = time.time()
    if opts.four:
        phase_four(devs)
    else:
        phase_dp(devs[0])
        log(f"phase dp done at {time.time() - t0:.0f} s")
        with tempfile.TemporaryDirectory() as workdir:
            params, reads = phase_e2e(workdir, card)
        log(f"phase e2e done at {time.time() - t0:.0f} s")
        phase_cpu(params, reads)
        log(f"phase cpu done at {time.time() - t0:.0f} s")
    d = devs[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
