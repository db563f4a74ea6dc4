"""blasr-jax command line (L7).

Mirrors the reference CLI surface (Blasr.cpp:3996-4139 flag registry,
MappingParameters::MakeSane at alignment/MappingParameters.h:367-545) with
the same single-dash spelling so benchmark scripts can swap binaries:

    blasr-jax reads.{fasta,fastq,sam} genome.fasta -m 4 -out out.m4 -bestn 2

Presets follow the reference: -nucmer (SetEmulateNucmer,
MappingParameters.h:547) and -useSensitiveSearch (SetForSensitivity, :560).

Usage: python -m blasr_jax.cli.blasr <reads> <genome> [options]
"""

from __future__ import annotations

import argparse
import os
import json
import sys
import time

from blasr_jax.params import MappingParams


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blasr-jax",
        description="GPU long-read aligner in JAX (BLASR-capability framework)",
    )
    p.add_argument("reads", help="reads file (FASTA/FASTQ/SAM)")
    p.add_argument("genome", help="reference genome FASTA")
    # ---- output selection ----
    p.add_argument("-m", type=int, default=4, choices=[0, 1, 2, 3, 4, 5],
                   help="output format (0=stick,1=columns,2=XML,3=vulgar,"
                        "4=interval,5=verbose)")
    p.add_argument("-sam", action="store_true", help="write SAM output")
    p.add_argument("-out", default="-", help="output file (default stdout)")
    p.add_argument("-clipping", default="soft",
                   choices=["none", "soft", "hard", "subread"])
    p.add_argument("-header", action="store_true", help="column header line")
    p.add_argument("-titleTable", default=None, metavar="FILE",
                   help="write contig-title table and print title indices")
    p.add_argument("-unaligned", default=None, metavar="FILE",
                   help="write unaligned read names to FILE")
    p.add_argument("-noPrintUnalignedSeqs", action="store_true",
                   help="names only in -unaligned file (no sequences)")
    # ---- selection / filtering ----
    p.add_argument("-bestn", type=int, default=1)
    p.add_argument("-nCandidates", type=int, default=6)
    p.add_argument("-maxScore", type=int, default=-200)
    p.add_argument("-minPctIdentity", type=float, default=0.0)
    p.add_argument("-minAlnLength", type=int, default=0)
    p.add_argument("-minReadLength", type=int, default=50)
    p.add_argument("-maxReadLength", type=int, default=0,
                   help="skip reads longer than this (0 = no limit)")
    p.add_argument("-placeRepeatsRandomly", action="store_true")
    p.add_argument("-randomSeed", type=int, default=0)
    p.add_argument("-readIndex", type=int, default=None,
                   help="map only the read at this stream index (repro aid, "
                        "Blasr.cpp:4619)")
    p.add_argument("-readIndices", default=None, metavar="I,J,...",
                   help="map only these stream indices")
    # ---- anchoring ----
    p.add_argument("-sa", default=None, metavar="FILE",
                   help="use a reference-format .sa suffix array file")
    p.add_argument("-bwt", nargs="?", const="", default=None, metavar="FILE",
                   help="anchor via the FM-index (low-memory path); optional "
                        "prebuilt .btfm.npz bundle (else built/cached)")
    p.add_argument("-minMatch", type=int, default=14)
    p.add_argument("-maxAnchorsPerPosition", type=int, default=8)
    p.add_argument("-minExpand", type=int, default=0,
                   help="starting anchor expand level (widen SA intervals "
                        "to the (minMatch-e)-base prefix)")
    p.add_argument("-maxExpand", type=int, default=0,
                   help="retry unmapped reads at increasing expand levels")
    p.add_argument("-pvaltype", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("-advanceExactMatches", type=int, default=0,
                   help="(accepted; anchor compaction covers this heuristic)")
    p.add_argument("-anchorStride", type=int, default=1,
                   help="seed every Nth read position (2 = the bench "
                        "operating point; the speed/sensitivity frontier)")
    p.add_argument("-dpCandidates", type=int, default=0,
                   help="candidate windows DP'd per read across strands "
                        "(0 = nCandidates; 2 = the bench operating point)")
    p.add_argument("-maxAnchorsPerRead", type=int, default=512,
                   help="anchors kept per read-strand (the anchor phase is "
                        "gather-bound in this size; 128 = the bench "
                        "operating point)")
    # ---- scoring ----
    p.add_argument("-indel", type=int, default=5)
    p.add_argument("-insertion", type=int, default=None)
    p.add_argument("-deletion", type=int, default=None)
    p.add_argument("-affineOpen", type=int, default=50)
    p.add_argument("-scoreMatrix", default=None, metavar='"25 ints"',
                   help="substitution matrix: 25 space-separated values, "
                        "row-major ACGTN x ACGTN (StringToScoreMatrix.h)")
    p.add_argument("-affineExtend", type=int, default=0)
    p.add_argument("-ignoreQualities", action="store_true",
                   help="disable QV-aware scoring for FASTQ input")
    p.add_argument("-affineAlign", action="store_true",
                   help="(always on: the DP kernel is affine)")
    # ---- input sharding (reference -start/-stride/-subsample) ----
    p.add_argument("-start", type=int, default=0)
    p.add_argument("-stride", type=int, default=1)
    p.add_argument("-subsample", type=float, default=1.0)
    # ---- presets ----
    p.add_argument("-nucmer", action="store_true",
                   help="nucmer emulation preset (SetEmulateNucmer)")
    p.add_argument("-alignContigs", "-piecewise", dest="alignContigs",
                   action="store_true",
                   help="piecewise long-query mapping (multi-Mb contigs)")
    p.add_argument("-useSensitiveSearch", action="store_true",
                   help="sensitivity preset (SetForSensitivity)")
    # ---- device shape/batch knobs ----
    p.add_argument("-maxReadLen", type=int, default=3072,
                   help="pad bound; longer reads are truncated (piecewise path for contigs)")
    p.add_argument("-batchSize", type=int, default=64)
    p.add_argument("-noSplitSubreads", action="store_true",
                   help="(accepted; subread splitting applies to region-annotated input)")
    p.add_argument("-nproc", type=int, default=1,
                   help="(accepted; device batching replaces threads)")
    p.add_argument("-ndevices", type=int, default=1,
                   help="chips for the serving path: 1=default device, "
                        "0=all visible, N=first N (batch sharded over a "
                        "dp mesh, index replicated)")
    # ---- observability ----
    p.add_argument("-anchors", default=None, metavar="FILE",
                   help="dump per-read anchors (qpos tpos nhits strand)")
    p.add_argument("-resume", action="store_true",
                   help="resume an interrupted run: append to -out, batch-"
                        "granular checkpoint manifest at <out>.resume.json")
    p.add_argument("-metrics", default=None, metavar="FILE",
                   help="write per-stage timing/counter metrics JSON")
    p.add_argument("-V", "-v", dest="verbosity", type=int, default=0, nargs="?",
                   const=1)
    p.add_argument("-version", action="version", version="blasr-jax 2.0")
    # ---- long-tail flags with direct semantics ----
    p.add_argument("-match", type=int, default=None,
                   help="match score (<= 0; min-score convention)")
    p.add_argument("-mismatch", type=int, default=None)
    p.add_argument("-sdpTupleSize", type=int, default=11)
    p.add_argument("-forwardOnly", action="store_true",
                   help="map the forward strand only")
    p.add_argument("-minMapQV", type=int, default=0)
    p.add_argument("-maxPctIdentity", type=float, default=100.0)
    p.add_argument("-minAvgQual", type=float, default=0.0)
    p.add_argument("-minAlignLength", dest="minAlnLength2", type=int,
                   default=None, help="alias of -minAlnLength")
    p.add_argument("-minSubreadLength", type=int, default=None,
                   help="alias of -minReadLength (whole reads = subreads "
                        "without region tables)")
    p.add_argument("-maxReadIndex", type=int, default=None,
                   help="map only reads with stream index < this")
    p.add_argument("-printOnlyBest", action="store_true",
                   help="equivalent to -bestn 1")
    p.add_argument("-samqv", nargs="+", default=None, metavar="NAME",
                   help="QV tags to emit in SAM (InsertionQV DeletionQV "
                        "SubstitutionQV MergeQV SubstitutionTag DeletionTag)")
    p.add_argument("-bandSize", "-guidedAlignBandSize", dest="bandSize",
                   type=int, default=0,
                   help="DP band half-width; the full band rounds up to "
                        "32, 64 or 128 cells (whole warps of the GPU DP)")
    p.add_argument("-useGuidedAlign", "-guidedAlign", dest="useGuidedAlign",
                   action="store_true", default=None,
                   help="per-read anchor-chain band guides (GuidedAlign.h "
                        "role): long buckets keep the base band width")
    p.add_argument("-noUseGuidedAlign", dest="useGuidedAlign",
                   action="store_false",
                   help="disable per-read band guides (length-scaled full "
                        "band on long buckets instead)")
    p.add_argument("-indelRate", type=float, default=0.3)
    p.add_argument("-minInterval", type=int, default=100,
                   help="minimum summed anchor bases for a candidate "
                        "interval (fork default 100, MappingParameters.h:348)")
    p.add_argument("-removeContained", action="store_true",
                   help="(always on: read-span containment gates -bestn)")
    # ---- accepted-for-compatibility flags (semantics subsumed by the
    # batched device design; see PARITY.md; each lists its coverage) ----
    _compat_int = [
        ("maxLCPLength", "anchor length cap: fixed-k seeding bounds this"),
        ("maxExtendDropoff", "window pad + local clamp subsume extension"),
        ("extendBandSize", "same"),
        ("maxAnchorGap", "diagonal-window clustering bounds gaps"),
        ("maxGap", "same"),
        ("branchExpand", "-minExpand/-maxExpand are the expand cascade"),
        ("nbranch", "same"),
        ("contextAlignLength", "not used outside HDF context"),
        ("recurseOver", "SDP recursion threshold (pipeline/sdp.py fixed)"),
        ("sdpIns", "SDP path uses the global -indel costs"),
        ("sdpDel", "same"),
        ("sdpindel", "same"),
        ("sdpMaxAnchorsPerPosition", "SDP seeding caps internally"),
        ("globalChainType", "one chaining algorithm by design"),
        ("sdpFilterType", "same"),
        ("maxRefine", "single-pass full-band refinement"),
        ("stopMappingOnceUnique", "anchor compaction covers the heuristic"),
        ("advanceHalf", "same"),
        ("saLookupTableLength", "direct 4^k table is built automatically"),
        ("maxMatch", "fixed-k seeding"),
        ("scoreType", "one score model + -scoreMatrix"),
        ("quallc", "low-complexity masking not needed for FASTA/FASTQ/SAM"),
    ]
    _compat_flag = [
        ("extend", "local 0-clamp + window pad extend alignments natively"),
        ("global", "piecewise path covers whole-query alignment"),
        ("noRefineAlignments", "single-pass design has no second stage"),
        ("noRefineAlign", "same"),
        ("refineBetweenAnchorsOnly", "piecewise/-alignContigs does this"),
        ("rbao", "same"),
        ("useDetailedSDP", "SDP gap fill is always exact"),
        ("nouseDetailedSDP", "same"),
        ("sdpbypass", "anchors feed the DP directly already"),
        ("allowAdjacentIndels", "DP emits whatever is optimal"),
        ("noFrontAlign", "local alignment trims ends by score"),
        ("onegap", "tools onegap / svrealign cover the SV path"),
        ("noSelf", "self-hits only arise in all-vs-all tooling"),
        ("outputByThread", "single ordered writer"),
        ("noStoreMapQV", "MAPQ is computed in the same fused program"),
        ("sortRefinedAlignments", "selection already sorts by score"),
        ("computeAlignProbability", "see -metrics JSON"),
        ("useQuality", "QV scoring is on whenever input has qualities"),
        ("preserveReadTitle", "titles are preserved verbatim already"),
        ("noPrintSubreadTitle", "whole-read titles (no region tables)"),
        ("forwardOnly2", None),
        ("p", "progress goes to stderr"),
        ("passthrough", "no daemon mode"),
        ("streaming", "batched pipeline streams by construction"),
        ("useTemp", "no temp files needed"),
        ("divideByAdapter", "adapter regions are HDF5-only"),
        ("ignoreRegions", "region tables are HDF5-only"),
        ("ignoreHQRegions", "same"),
    ]
    grp = p.add_argument_group("accepted for reference compatibility")
    for name, note in _compat_int:
        grp.add_argument(f"-{name}", type=float, default=None,
                        help=f"accepted; {note}")
    for name, note in _compat_flag:
        if name == "forwardOnly2":
            continue
        grp.add_argument(f"-{name}", action="store_true",
                        help=f"accepted; {note}" if note else "accepted")
    for name in ("accuracyPrior", "deletionPrior", "substitutionPrior",
                 "idsIndel", "minFrac", "minRatio", "overlap"):
        grp.add_argument(f"-{name}", type=float, default=None,
                        help="accepted; probability-model priors are folded "
                             "into the QV-scaled costs")
    for name in ("ctab", "seqdb", "findex", "regionTable", "fileType"):
        grp.add_argument(f"-{name}", default=None, metavar="FILE",
                        help="accepted; artifact auto-discovery covers this")
    p.add_argument("-fullMetrics", default=None, metavar="FILE",
                   help="write per-read metric rows (role of reference "
                        "MappingMetrics PrintFullList, MappingMetrics.h:307; "
                        "stage clocks are amortized per read — the device maps "
                        "whole batches in one fused program)")
    p.add_argument("-clusters", default=None, metavar="FILE",
                   help="write candidate-cluster statistics "
                        "(Blasr.cpp:4536 header; the reference fork itself "
                        "emits the header only — rows here carry per-"
                        "alignment cluster stats)")
    p.add_argument("-lcpBounds", default=None, metavar="FILE",
                   help="per read, the SA match-interval width at every "
                        "seed position (MapBySuffixArray.h:77-85)")
    return p


def params_from_args(args) -> MappingParams:
    """Flag bag -> MappingParams, applying MakeSane-style normalization."""
    best_n = max(1, args.bestn)
    n_cand = max(args.nCandidates, best_n)
    min_match = args.minMatch
    insertion = args.insertion if args.insertion is not None else args.indel
    deletion = args.deletion if args.deletion is not None else args.indel
    score_matrix = None
    if args.scoreMatrix is not None:
        vals = args.scoreMatrix.replace(",", " ").split()
        if len(vals) != 25:
            raise SystemExit(
                f"-scoreMatrix needs 25 values, got {len(vals)}"
            )
        score_matrix = tuple(int(v) for v in vals)
        if any(score_matrix[i * 5 + i] > 0 for i in range(4)):
            raise SystemExit("-scoreMatrix: diagonal (match) values must be <= 0")
    if args.nucmer:
        # SetEmulateNucmer (MappingParameters.h:547): exact-match oriented
        min_match = max(min_match, 30 if min_match == 14 else min_match)
        args.maxScore = min(args.maxScore, -200)
    if args.useSensitiveSearch:
        # SetForSensitivity (MappingParameters.h:560): more candidates,
        # lower match threshold
        n_cand = max(n_cand, 10)
        min_match = min(min_match, 12)
    best_n = 1 if args.printOnlyBest else best_n
    min_aln = args.minAlnLength
    if args.minAlnLength2 is not None:
        min_aln = max(min_aln, int(args.minAlnLength2))
    min_rd = args.minReadLength
    if args.minSubreadLength is not None:
        min_rd = max(min_rd, int(args.minSubreadLength))
    # -bandSize/-guidedAlignBandSize: round the full band up to whole warps
    # of the GPU DP (one band cell per lane)
    nb_kw = {}
    if args.bandSize:
        full = 2 * args.bandSize
        nb = 32 if full <= 32 else (64 if full <= 64 else 128)
        nb_kw = dict(narrow_band=nb)
    samqv = None
    if args.samqv is not None:
        name_to_tag = {
            "InsertionQV": "iq", "DeletionQV": "dq", "SubstitutionQV": "sq",
            "MergeQV": "mq", "SubstitutionTag": "st", "DeletionTag": "dt",
        }
        bad = [n for n in args.samqv if n not in name_to_tag]
        if bad:
            raise SystemExit(f"-samqv: unknown QV names {bad}")
        samqv = tuple(name_to_tag[n] for n in args.samqv)
    match_kw = {}
    if args.match is not None:
        if args.match > 0:
            raise SystemExit("-match must be <= 0 (min-score convention)")
        match_kw["match_score"] = args.match
    if args.mismatch is not None:
        match_kw["mismatch_score"] = args.mismatch
    return MappingParams(
        min_match_length=min_match,
        anchor_stride=max(1, args.anchorStride),
        n_dp_candidates=args.dpCandidates or None,
        sdp_tuple_size=args.sdpTupleSize,
        forward_only=args.forwardOnly,
        min_map_qv=args.minMapQV,
        max_pct_identity=args.maxPctIdentity,
        min_avg_qual=args.minAvgQual,
        indel_rate=args.indelRate,
        samqv=samqv,
        **nb_kw,
        **match_kw,
        max_anchors_per_position=args.maxAnchorsPerPosition,
        max_anchors_per_read=args.maxAnchorsPerRead,
        n_candidates=n_cand,
        best_n=best_n,
        pval_type=args.pvaltype,
        insertion_score=insertion,
        deletion_score=deletion,
        affine_open=args.affineOpen,
        affine_extend=args.affineExtend,
        score_matrix=score_matrix,
        max_score=args.maxScore,
        min_pct_similarity=args.minPctIdentity,
        min_align_length=min_aln,
        min_read_length=min_rd,
        max_read_len=args.maxReadLen,
        batch_size=args.batchSize,
        place_repeats_randomly=args.placeRepeatsRandomly,
        random_seed=args.randomSeed,
        piecewise=args.alignContigs,
        sensitive_retry=args.useSensitiveSearch,
        ndevices=args.ndevices,
        ignore_qualities=args.ignoreQualities,
        min_expand=args.minExpand,
        max_expand=max(args.maxExpand, args.minExpand),
        # reference default false; -alignContigs preset enables it
        # (MappingParameters.h:350,469)
        remove_contained=args.removeContained or args.alignContigs,
        min_interval=args.minInterval,
        **(
            {}
            if args.useGuidedAlign is None
            else {"guided_band": args.useGuidedAlign}
        ),
        # -m 4 output is fully determined by coordinates + stats; only
        # SAM/m0-m5/piecewise consumers replay the per-base move strings,
        # so the m4 serving path skips shipping them over the host link
        # (see MappingParams.emit_moves). best_n > 1 forces them back on.
        emit_moves=bool(args.sam or args.m != 4 or args.alignContigs),
    )


def _run_resumable(args, params, index, reads, fm):
    """Batch-granular checkpointed mapping (role of the §5 gap: the
    reference has no mapping-run checkpointing — rerun with -start/-stride
    is its only recovery story). The output file grows batch by batch; a
    manifest records progress so a preempted run resumes at the last
    flushed batch."""
    import json as _json
    import os

    from blasr_jax.output.m4 import format_m4
    from blasr_jax.output.sam_writer import format_sam_record, sam_header
    from blasr_jax.pipeline.runner import run_mapping as _run

    manifest_path = args.out + ".resume.json"
    key = {
        "reads": os.path.abspath(args.reads),
        "reads_bytes": os.path.getsize(args.reads),
        "genome": os.path.abspath(args.genome),
        "params": repr(params),
        "sam": bool(args.sam),
    }
    skip = 0
    pending_prev: list[str] = []
    if os.path.exists(manifest_path) and os.path.exists(args.out):
        try:
            with open(manifest_path) as f:
                m = _json.load(f)
            if m.get("key") == key:
                skip = int(m.get("batches_done", 0))
                # reads whose records were stream-deferred (retry passes
                # could still replace them) in already-flushed batches of
                # the interrupted run: re-map them in a follow-up pass
                pending_prev = list(m.get("deferred", []))
        except (OSError, ValueError):
            pass
    mode = "a" if skip else "w"
    by_name = {r.name: r for r in reads}
    from blasr_jax.output.sam_writer import read_group_id

    # movie/RG naming must match the non-resume path (basename, not full
    # path) so the same command emits identical @RG ID/PU with or
    # without -resume.
    movie = os.path.basename(args.reads)
    rgid = read_group_id(movie)
    out_f = open(args.out, mode)
    if not skip and args.sam:
        for line in sam_header(index.seqdb, " ".join(sys.argv), [movie]):
            out_f.write(line + "\n")

    state = {"done": skip, "deferred": set(pending_prev)}

    def on_batch(bi, recs, unm, deferred=None):
        if args.sam:
            # per-read primary selection within the batch (all candidates
            # for one read land in the same batch)
            by_read: dict[int, list] = {}
            for rec in recs:
                by_read.setdefault(rec.read_index, []).append(rec)
            best_of = {
                ri: min(range(len(rs)), key=lambda j: rs[j].score)
                for ri, rs in by_read.items()
            }
            for ri, rs in by_read.items():
                for j, rec in enumerate(rs):
                    # key by read index (duplicate names are legal in FASTA)
                    rd = (
                        reads[rec.read_index]
                        if 0 <= rec.read_index < len(reads)
                        else by_name.get(rec.qname)
                    )
                    if rd is not None:
                        out_f.write(
                            format_sam_record(
                                rec, rd, args.clipping, rgid=rgid,
                                genome=index.genome,
                                genome_start=int(index.seqdb.starts[rec.contig_index])
                                if rec.contig_index >= 0 else 0,
                                is_primary=(j == best_of[ri]),
                                samqv=params.samqv,
                            )
                            + "\n"
                        )
        else:
            for rec in recs:
                out_f.write(format_m4(rec) + "\n")
        out_f.flush()
        if bi >= 0:
            state["done"] = max(state["done"], bi + 1)
            if deferred:
                state["deferred"].update(deferred)
        else:
            # final delivery of the retry-resolved records: those reads
            # are now on disk, drop them from the pending set
            state["deferred"].difference_update(r.qname for r in recs)
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            _json.dump(
                {
                    "key": key,
                    "batches_done": state["done"],
                    "deferred": sorted(state["deferred"]),
                },
                f,
            )
        os.replace(tmp, manifest_path)

    try:
        records, unmapped = _run(
            index, reads, params, fm=fm, on_batch=on_batch, skip_batches=skip
        )
        if pending_prev:
            # deferred reads from flushed batches of the interrupted run:
            # their records never reached the output file — re-map them
            # through the full retry cascade and append the results
            sub = [r for r in reads if r.name in set(pending_prev)]
            if sub:
                r2, _ = _run(index, sub, params, fm=fm)
                records = records + r2
                on_batch(-1, r2, [])
    finally:
        out_f.close()
    return records, unmapped


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    params = params_from_args(args)
    params.validate()

    # honesty: a compat flag that names an output/input FILE but produces
    # no file must say so loudly, not swallow the user's diagnostics
    for noop in ("ctab", "seqdb", "findex", "regionTable", "fileType"):
        if getattr(args, noop, None):
            print(
                f"[blasr_jax] warning: -{noop} is accepted for reference "
                "compatibility but has no effect (index artifacts are "
                "auto-discovered); no file will be read or written",
                file=sys.stderr,
            )
    if getattr(args, "computeAlignProbability", False):
        print(
            "[blasr_jax] warning: -computeAlignProbability has no separate "
            "output here; use -metrics FILE for the run statistics",
            file=sys.stderr,
        )

    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.output.m4 import write_m4
    from blasr_jax.output.sam_writer import write_sam
    from blasr_jax.pipeline.runner import run_mapping

    t_start = time.time()
    fm = None
    if args.bwt is not None:
        # low-memory path: skip the SA bundle entirely; the mapper's FM
        # branch needs only genome codes + seed-validity + contig db
        import numpy as np

        from blasr_jax.cli.bwtutils import FM_SUFFIX
        from blasr_jax.index.artifacts import GenomeIndex, build_pos_ok
        from blasr_jax.index.fm import FMIndex, build_fm_index
        from blasr_jax.index.suffix_array import build_suffix_array
        from blasr_jax.io.seqdb import load_genome

        genome, seqdb = load_genome(args.genome)
        k = params.min_match_length
        pos_ok = build_pos_ok(genome, seqdb, k)
        empty = np.zeros(0, np.int32)
        index = GenomeIndex(genome, empty, empty, pos_ok, k, seqdb)
        fm_path = args.bwt or (args.genome + FM_SUFFIX)
        if fm_path.endswith(".bwt") and os.path.exists(fm_path):
            # reference binary .bwt (BWT.h:70-80 layout): invert it, verify
            # the content matches the FASTA genome, then build our FM
            from blasr_jax.index.bwtfile import (
                read_ref_bwt, ref_bwt_genome_matches,
            )
            from blasr_jax.io.fasta import read_fasta

            rg = read_ref_bwt(fm_path)
            if not ref_bwt_genome_matches(rg, read_fasta(args.genome)):
                raise SystemExit(
                    f"{fm_path}: .bwt content does not match {args.genome}"
                )
            fm = build_fm_index(genome, build_suffix_array(genome))
        elif os.path.exists(fm_path):
            fm = FMIndex.load(fm_path)
        else:
            fm = build_fm_index(genome, build_suffix_array(genome))
            try:
                fm.save(fm_path)
            except OSError:
                pass
    elif args.sa is not None:
        # reference-format .sa input (SuffixArray.h:505 layout): reuse the
        # precomputed array, derive the device-side artifacts from it
        from blasr_jax.index.artifacts import build_index_from_sa

        index = build_index_from_sa(
            args.genome, args.sa, k=params.min_match_length
        )
    else:
        index = load_index(args.genome, k=params.min_match_length)
    t_index = time.time() - t_start
    reads = read_records(args.reads)
    if args.start or args.stride > 1 or args.subsample < 1.0:
        import numpy as np

        rng = np.random.default_rng(args.randomSeed)
        reads = [
            r for i, r in enumerate(reads)
            if i >= args.start and (i - args.start) % args.stride == 0
            and (args.subsample >= 1.0 or rng.random() < args.subsample)
        ]
    if args.maxReadLength:
        reads = [r for r in reads if len(r) <= args.maxReadLength]
    if args.maxReadIndex is not None:
        reads = [r for r in reads if r.index < args.maxReadIndex]
    if args.readIndex is not None or args.readIndices:
        want = set()
        if args.readIndex is not None:
            want.add(args.readIndex)
        if args.readIndices:
            want.update(int(x) for x in args.readIndices.split(","))
        reads = [r for r in reads if r.index in want]

    if args.titleTable:
        with open(args.titleTable, "w") as f:
            for name in index.seqdb.names:
                f.write(name + "\n")
        # ResetTableToIntegers (Blasr.cpp:4495, TitleTable.h role): output
        # refers to contigs by their table index; the table file maps back
        index.seqdb.names = [str(i) for i in range(len(index.seqdb.names))]

    t0 = time.time()
    if args.resume and args.out.endswith(".bam"):
        raise SystemExit(
            "-resume streams text records and cannot write BAM; "
            "resume to .sam and convert, or drop -resume"
        )
    if args.resume and args.out != "-" and not params.piecewise:
        records, unmapped = _run_resumable(args, params, index, reads, fm)
        t_map = time.time() - t0
    else:
        if params.piecewise:
            from blasr_jax.pipeline.piecewise import run_mapping_piecewise

            records, unmapped = run_mapping_piecewise(index, reads, params, fm=fm)
        else:
            records, unmapped = run_mapping(index, reads, params, fm=fm)
        t_map = time.time() - t0

        out = sys.stdout if args.out == "-" else open(args.out, "w")
        try:
            if args.sam and args.out.endswith(".bam"):
                import io as _io

                buf = _io.StringIO()
                write_sam(records, reads, index.seqdb, buf,
                          clipping=args.clipping,
                          program_line=" ".join(sys.argv),
                          unmapped=unmapped,
                          movie_name=os.path.basename(args.reads),
                          genome=index.genome,
                          samqv=params.samqv)
                from blasr_jax.io.bam import write_bam_from_sam_lines

                lines = buf.getvalue().split("\n")
                hdr = [l for l in lines if l.startswith("@")]
                recs_l = [l for l in lines if l and not l.startswith("@")]
                out.close() if out is not sys.stdout else None
                write_bam_from_sam_lines(hdr, recs_l, args.out)
                out = sys.stdout  # avoid double close below
            elif args.sam:
                write_sam(records, reads, index.seqdb, out,
                          clipping=args.clipping,
                          program_line=" ".join(sys.argv),
                          unmapped=unmapped,
                          movie_name=os.path.basename(args.reads),
                          genome=index.genome,
                          samqv=params.samqv)
            elif args.m == 4:
                write_m4(records, out, header=args.header)
            else:
                from blasr_jax.output.verbose import write_verbose

                write_verbose(records, reads, index, out, fmt=args.m,
                              header=args.header)
        finally:
            if out is not sys.stdout:
                out.close()

    if args.unaligned:
        from blasr_jax.core.encode import codes_to_seq

        # every unmapped OCCURRENCE is written (duplicate read names are
        # legal in FASTA; a name->read dict would collapse them)
        unmapped_names = set(unmapped)
        with open(args.unaligned, "w") as f:
            emitted = 0
            for rd in reads:
                if rd.name not in unmapped_names:
                    continue
                if args.noPrintUnalignedSeqs:
                    f.write(rd.name + "\n")
                else:
                    f.write(f">{rd.name}\n")
                    f.write(codes_to_seq(rd.codes) + "\n")
                emitted += 1

    if args.anchors:
        from blasr_jax.pipeline.debug import dump_anchors

        with open(args.anchors, "w") as f:
            dump_anchors(index, reads, params, f, fm=fm)

    if args.fullMetrics:
        from blasr_jax.pipeline import runner as _runner
        from blasr_jax.pipeline.diagnostics import write_full_metrics

        with open(args.fullMetrics, "w") as f:
            write_full_metrics(
                f, reads, records, unmapped, _runner.LAST_RUN_METRICS
            )

    if args.clusters:
        from blasr_jax.pipeline.diagnostics import write_clusters

        with open(args.clusters, "w") as f:
            write_clusters(f, reads, records)

    if args.lcpBounds:
        from blasr_jax.pipeline.diagnostics import write_lcp_bounds

        if getattr(index, "sa_kmers", None) is None or fm is not None:
            print(
                "[blasr_jax] warning: -lcpBounds needs the suffix-array "
                "index (not available on the -bwt path); skipping",
                file=sys.stderr,
            )
        else:
            with open(args.lcpBounds, "w") as f:
                write_lcp_bounds(f, reads, index)

    if args.metrics:
        from blasr_jax.pipeline import runner as _runner

        m = {
            "nReads": len(reads),
            "nMapped": len(reads) - len(unmapped),
            "nUnmapped": len(unmapped),
            "nAlignments": len(records),
            "indexLoadSeconds": round(t_index, 3),
            "mapSeconds": round(t_map, 3),
            "readsPerSecond": round(len(reads) / t_map, 2) if t_map > 0 else 0.0,
            "totalSeconds": round(time.time() - t_start, 3),
            "stages": _runner.LAST_RUN_METRICS.to_dict(),
        }
        with open(args.metrics, "w") as f:
            json.dump(m, f, indent=2)

    print(
        f"Finished mapping {len(reads) - len(unmapped)}/{len(reads)} reads",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
