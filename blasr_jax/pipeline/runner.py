"""End-to-end mapping run: reads -> alignment records (L5 host loop).

Role of reference ``MapReads`` worker loop (Blasr.cpp:3193-3917) and
coordinate assignment (``AssignRefContigLocations``, Blasr.cpp:2186).
Host pulls padded batches, dispatches the jitted device step, walks
tracebacks, converts window-local coordinates to contig coordinates and
applies the reporting filters (maxScore/minPctSimilarity/minAlnLength,
cf. PrintAlignments filters at Blasr.cpp:2958-2978).

m4 coordinate convention (reference IntervalAlignmentPrinter.h): qstrand is
always 0; when tstrand == 1 the target interval is reported in
reverse-complement coordinates of the contig; qstart/qend always refer to
the forward (original) read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from blasr_jax.index.artifacts import GenomeIndex
from blasr_jax.io.batching import Read, ReadBatch, batch_reads
from blasr_jax.params import MappingParams
from blasr_jax.pipeline.mapper import Mapper, unpack_result
from blasr_jax.ops.traceback_device import unpack_moves
from blasr_jax.pipeline.traceback import AlignmentPath


@dataclasses.dataclass
class MappingMetrics:
    """Per-run counters and stage timers (role of reference
    MappingMetrics/MappingClocks, datastructures/mapping/MappingMetrics.h:
    per-stage tick/tock + counters, merged across workers at join)."""

    n_reads: int = 0
    n_batches: int = 0
    n_records: int = 0
    n_unmapped: int = 0
    total_aligned_bases: int = 0
    total_dp_cells: int = 0
    dispatch_seconds: float = 0.0   # host time enqueueing device work
    wait_seconds: float = 0.0       # host time blocked on device + d2h
    finalize_seconds: float = 0.0   # host time draining + formatting
    wall_seconds: float = 0.0
    buckets: dict = dataclasses.field(default_factory=dict)
                                    # bucket cap -> [n_batches, n_reads]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.wall_seconds > 0:
            d["readsPerSecond"] = round(self.n_reads / self.wall_seconds, 2)
        return d


LAST_RUN_METRICS = MappingMetrics()


def _escalation_candidates(records, params) -> set:
    """Read names whose best record shows the narrow-band clipping
    signature (pct similarity < 80 or query coverage < 0.97 on a
    narrow-band bucket). One predicate shared by the band-escalation
    retry and the streaming deferral below, so the set of reads held
    back from streaming is exactly the set the retry may replace.

    Trigger recalibrated round 5 on the reference-alchemy corpus
    (scripts/escalation_probe2.py at HEAD): the narrow-everywhere band
    newly breaks 1/1920 reads there, and the old qcov < 0.90 bound let
    it escape (qcov 0.960, sim 82.3, len 2164). The tightened
    qcov < 0.97 bound applies only to reads LONGER than 1536 bp — the
    population that was wide-banded before narrow-everywhere and where
    every observed victim lives — so it catches 1/1 while flagging only
    2/897 long intact reads (bench-corpus reads, mostly <= 1536, keep
    the cheap 0.90 bound: the tightened bound applied globally cost a
    measured ~3% of bench throughput in ride-along retries)."""
    best_by: dict = {}
    for r in records:
        cur = best_by.get(r.qname)
        if cur is None or r.score < cur.score:
            best_by[r.qname] = r
    names = set()
    for nm, rec in best_by.items():
        if params.band_width_for(rec.qlength) >= 128:
            continue  # already mapped with a wide band
        qcov = (rec.qend - rec.qstart) / max(rec.qlength, 1)
        cov_thr = 0.97 if rec.qlength > 1536 else 0.90
        if rec.pct_similarity < 80.0 or qcov < cov_thr:
            names.add(nm)
    return names


def _stream_defer_names(records, params) -> set:
    """Read names a retry pass may still REPLACE records for — held back
    from per-batch streaming so streamed output equals the in-memory
    result (the round-4 divergence: escalation/sensitive replacements
    reached only the returned list, never the -resume stream)."""
    names: set = set()
    if params.band_escalation and params.narrow_band:
        names |= _escalation_candidates(records, params)
    if params.sensitive_retry:
        best_pct: dict = {}
        for r in records:
            best_pct[r.qname] = max(
                best_pct.get(r.qname, 0.0), r.pct_similarity
            )
        names |= {n for n, p in best_pct.items() if p < 80.0}
    return names


@dataclasses.dataclass
class AlignmentRecord:
    """One reported alignment (all coordinates ready for m4/SAM printing)."""

    qname: str
    tname: str
    score: int
    pct_similarity: float
    qstrand: int          # always 0 (blasr convention)
    qstart: int           # forward-read coords
    qend: int
    qlength: int
    tstrand: int          # 0/1
    tstart: int           # fwd coords if tstrand==0 else RC-of-contig coords
    tend: int
    tlength: int
    mapqv: int
    # extras for SAM emission
    contig_index: int = -1
    tstart_fwd: int = 0   # contig-forward coords, always
    tend_fwd: int = 0
    path: Optional[AlignmentPath] = None
    read_index: int = -1
    nhits_considered: int = 0


def run_mapping(
    index: GenomeIndex,
    reads: Sequence[Read],
    params: MappingParams,
    fm=None,
    on_batch=None,
    skip_batches: int = 0,
) -> tuple[list[AlignmentRecord], list[str]]:
    """Map reads; returns (alignments, unmapped read names).

    Batches are dispatched ahead of host post-processing (JAX async
    dispatch), so device compute, host<->device transfers and host
    formatting overlap — the device analogue of the reference's
    reader/writer pipeline (Blasr.cpp:3131-3177,3066-3126).

    ``on_batch(batch_idx, records, unmapped_names)`` fires after each batch
    finalizes (deterministic order) — the hook behind batch-granular
    output checkpointing; ``skip_batches`` resumes a checkpointed run by
    skipping already-flushed batches (batching is deterministic for fixed
    inputs + params).
    """
    from collections import deque

    if (
        params.auto_segment
        and on_batch is None
        and skip_batches == 0
        and reads
        and max(len(r) for r in reads) > params.max_read_len
    ):
        # (checkpointed runs stream batch-level records; they keep the
        # truncation behavior for over-length reads instead)
        # Reads beyond the pad bound are piecewise-mapped instead of
        # truncated: segmentation bounds per-DP indel drift (W/2 per
        # segment) and the stitcher restores whole-read records.
        from blasr_jax.pipeline.piecewise import run_mapping_piecewise

        return run_mapping_piecewise(
            index, reads, params, fm=fm,
            split_if_longer=params.max_read_len,
        )

    import time as _time

    global LAST_RUN_METRICS
    met = MappingMetrics()
    t_run0 = _time.time()
    # adaptive candidate depth: the main pass runs a CD=1 program; reads
    # whose batch result carries the second-admitted-window flag re-run
    # through the full-CD program afterwards and their records are
    # REPLACED wholesale. Exactness: a read without a second admitted
    # window produces identical records at any CD (the extra slots are
    # invalid and contribute nothing to selection or MAPQ), and flagged
    # reads go through the ordinary full-CD program.
    adaptive = (
        params.adaptive_cd
        and params.best_n == 1
        and params.dp_candidates > 1
    )
    map_params = (
        dataclasses.replace(params, n_dp_candidates=1) if adaptive else params
    )
    adaptive_names: set[str] = set()
    mapper = Mapper(index, map_params, fm=fm)
    out: list[AlignmentRecord] = []
    unmapped: list[str] = []
    if params.min_read_length > 0 or params.min_avg_qual > 0:
        # reference length/quality input filters (Blasr.cpp:3327-3343):
        # rejected reads are reported unaligned without entering the pipeline
        def _ok(r):
            if len(r) < params.min_read_length:
                return False
            if (
                params.min_avg_qual > 0 and r.qual is not None
                and len(r.qual) and float(r.qual.mean()) < params.min_avg_qual
            ):
                return False
            return True

        bad = [r for r in reads if not _ok(r)]
        unmapped.extend(r.name for r in bad)
        reads = [r for r in reads if _ok(r)]
    from concurrent.futures import ThreadPoolExecutor

    from blasr_jax.pipeline.mapper import WireResult

    # concurrent device-to-host fetches: params.fetch_threads copies
    # overlap each other and the device compute of later batches
    fetch_pool = ThreadPoolExecutor(max_workers=max(1, params.fetch_threads))

    def _fetch(res):
        if isinstance(res, WireResult):
            return res._replace(wire=np.asarray(res.wire))
        return res

    inflight: deque = deque()
    drained = [0]

    # streamed == in-memory discipline: when a retry pass may REPLACE a
    # record (band escalation on narrow-band buckets), hold the affected
    # reads' records back from the per-batch stream and deliver the
    # resolved versions in the final on_batch(-1, ...) call, so streaming
    # consumers (-resume writers) see the same record set as the in-memory
    # return. The resumable writer persists the held-back names in its
    # manifest (4th on_batch argument) so an interrupted run re-maps them.
    defer_stream = on_batch is not None and (
        (params.band_escalation and bool(params.narrow_band))
        or params.sensitive_retry
        or adaptive
    )
    deferred_names: set[str] = set()
    on_batch_4 = False
    if on_batch is not None:
        import inspect

        try:
            on_batch_4 = len(inspect.signature(on_batch).parameters) >= 4
        except (TypeError, ValueError):
            on_batch_4 = False

    def drain_one():
        t0 = _time.time()
        bi, batch, fut = inflight.popleft()
        dres = fut.result()
        t1 = _time.time()
        met.wait_seconds += t1 - t0
        t0 = t1
        out_b, unm_b = _finalize_batch(mapper, batch, dres)
        amb: set[str] = set()
        if adaptive:
            resu = unpack_result(dres, mapper.params.dp_candidates)
            amb = {
                batch.names[bb]
                for bb in range(len(batch.names))
                if batch.indices[bb] >= 0 and resu.cand_ambig[bb]
            }
            adaptive_names.update(amb)
        out.extend(out_b)
        unmapped.extend(unm_b)
        if on_batch is not None:
            stream_b = out_b
            dn: set[str] = set(amb)
            if defer_stream:
                dn |= _stream_defer_names(out_b, params)
                if dn:
                    deferred_names.update(dn)
                    stream_b = [r for r in out_b if r.qname not in dn]
            if on_batch_4:
                on_batch(bi, stream_b, unm_b, dn)
            else:
                on_batch(bi, stream_b, unm_b)
        drained[0] += 1
        met.finalize_seconds += _time.time() - t0
        met.n_batches += 1
        met.n_records += len(out_b)
        for r in out_b:
            if r.path is not None:
                met.total_aligned_bases += r.path.n_aligned

    for bi, batch in enumerate(
        batch_reads(reads, params.batch_size, params.max_read_len)
    ):
        if bi < skip_batches:
            continue
        t0 = _time.time()
        res = mapper.map_batch(batch.codes, batch.lengths, batch.qual)
        inflight.append((bi, batch, fetch_pool.submit(_fetch, res)))
        met.dispatch_seconds += _time.time() - t0
        bk = met.buckets.setdefault(int(batch.codes.shape[1]), [0, 0])
        bk[0] += 1
        bk[1] += int((batch.indices >= 0).sum())
        met.total_dp_cells += (
            (2 * batch.max_len + params.target_pad - 1)
            * params.band_width_for(batch.max_len)
            * params.dp_candidates
            * batch.batch_size
        )
        if len(inflight) > params.dispatch_ahead:
            drain_one()
    while inflight:
        drain_one()
    fetch_pool.shutdown(wait=False)
    if adaptive and adaptive_names:
        # full-depth re-map of the flagged ~10%: their CD=1 records are
        # replaced WHOLESALE (the full-CD program is the ground truth for
        # reads with a competing window); retries/escalation below then
        # operate on the merged result exactly as in the flat-CD flow
        retry_reads = [r for r in reads if r.name in adaptive_names]
        pr = dataclasses.replace(
            params, adaptive_cd=False,
            band_escalation=False, sensitive_retry=False,
            max_expand=params.min_expand,
        )
        r2, u2 = run_mapping(index, retry_reads, pr, fm=fm)
        out = [r for r in out if r.qname not in adaptive_names] + r2
        unmapped = [u for u in unmapped if u not in adaptive_names] + u2
    # late_names: reads whose records never reached per-batch streaming
    # (expand-recovered, stream-deferred, sensitive-recovered); their FINAL
    # records (after every retry pass resolved) go out in on_batch(-1, ...)
    late_names: set[str] = set()
    if params.max_expand > params.min_expand and unmapped:
        # expand-retry cascade (Blasr.cpp:2263,2554-2578 do/while +
        # CheckForSufficientMatch at :1974): reads with no sufficient match
        # re-run at increasing anchor expand levels; each level widens every
        # SA interval to the (k - expand)-base prefix interval
        retry_names = set(unmapped)
        retry_reads = [r for r in reads if r.name in retry_names]
        for e in range(params.min_expand + 1, params.max_expand + 1):
            if not retry_reads:
                break
            pe = dataclasses.replace(
                params, min_expand=e, max_expand=e, sensitive_retry=False
            )
            r2, u2 = run_mapping(index, retry_reads, pe, fm=fm)
            out.extend(r2)
            late_names.update(rec.qname for rec in r2)
            got = {rec.qname for rec in r2}
            unmapped = [u for u in unmapped if u not in got]
            still = set(u2)
            retry_reads = [r for r in retry_reads if r.name in still]
    if params.band_escalation and params.narrow_band:
        # band-escalation retry: the packed narrow band (W <= 64) is
        # lossless on the vast majority of reads, but a read whose true
        # path drifts out of it (bursty clustered indels on long reads)
        # surfaces with clipped query coverage or depressed similarity.
        # Re-map ONLY those through the length-scaled wide band
        # (band_width_for: 256 at 2-3.3 kb; one-sided burst excursions
        # exceed the guided knots' +-(W-8) clamp, so the wide band is the
        # robust escalation target — measured in the escalation test:
        # a 180-base insertion burst scores -11950/93% wide vs -6615/70%
        # guided-128) and keep whichever pass scores better. This buys
        # the robustness the reference gets by running EVERY read inside
        # a per-read guide (GuidedAlign.h:279) while paying wide-band
        # cost only on the flagged few (trigger recalibrated round 5 on
        # the reference-alchemy corpus, scripts/escalation_probe2.py at
        # HEAD: 1/1 newly-broken reads caught at <80% sim or <97% qcov,
        # 0.1% of intact reads ride along).
        best_by: dict[str, AlignmentRecord] = {}
        for r in out:
            cur = best_by.get(r.qname)
            if cur is None or r.score < cur.score:
                best_by[r.qname] = r
        retry_names = _escalation_candidates(out, params)
        retry_reads = [r for r in reads if r.name in retry_names]
        if retry_reads:
            esc = dataclasses.replace(
                params,
                band_escalation=False, sensitive_retry=False,
                narrow_band=0, guided_band=False,
            )
            r2, _ = run_mapping(index, retry_reads, esc, fm=fm)
            best2: dict[str, int] = {}
            for r in r2:
                best2[r.qname] = min(best2.get(r.qname, 0), r.score)
            use_retry = {
                n for n, s2 in best2.items()
                if s2 < best_by[n].score
            }
            out = [
                r for r in out if r.qname not in use_retry
            ] + [r for r in r2 if r.qname in use_retry]
            # streaming consumers never saw the narrow-pass records of
            # these reads (drain_one deferred them); the resolved versions
            # are delivered in the final on_batch(-1, ...) below
    if params.sensitive_retry:
        # reference sensitive retry (Blasr.cpp:3498-3507): re-map reads that
        # are unmapped or aligned below 80% similarity with wider search
        # parameters (SetForSensitivity role: more candidates, more anchors)
        best_pct: dict[str, float] = {}
        for r in out:
            best_pct[r.qname] = max(best_pct.get(r.qname, 0.0), r.pct_similarity)
        retry_names = set(unmapped) | {
            n for n, pct in best_pct.items() if pct < 80.0
        }
        retry_reads = [r for r in reads if r.name in retry_names]
        if retry_reads:
            sens = dataclasses.replace(
                params,
                sensitive_retry=False,
                n_candidates=min(params.n_candidates * 2, 16),
                max_anchors_per_read=params.max_anchors_per_read * 2,
                max_anchors_per_position=params.max_anchors_per_position * 2,
            )
            r2, u2 = run_mapping(index, retry_reads, sens, fm=fm)
            # keep whichever pass produced the better best-score per read
            best2: dict[str, int] = {}
            for r in r2:
                best2[r.qname] = min(best2.get(r.qname, 0), r.score)
            best1: dict[str, int] = {}
            for r in out:
                if r.qname in retry_names:
                    best1[r.qname] = min(best1.get(r.qname, 0), r.score)
            use_retry = {
                n for n, s2 in best2.items() if s2 < best1.get(n, 0)
            }
            out = [
                r for r in out if r.qname not in use_retry
            ] + [r for r in r2 if r.qname in use_retry]
            # reads recovered here had no streamed record (previously
            # unmapped, or deferred by _stream_defer_names which covers the
            # pct < 80 retry trigger); replacements for deferred reads are
            # delivered via late_names below
            late_names.update(
                r.qname for r in r2
                if r.qname in use_retry and r.qname not in best1
            )
            unmapped = [u for u in unmapped if u not in best2]
    late_names |= deferred_names
    if on_batch is not None and late_names:
        # resolved records of every never-streamed read (original if no
        # retry won, the replacement if one did) reach batch-streaming
        # consumers in one final call (bi=-1: appended without advancing
        # the resume manifest) — streamed record set == in-memory set
        stream_extra = [r for r in out if r.qname in late_names]
        if stream_extra:
            on_batch(-1, stream_extra, [])
    order = {r.name: i for i, r in enumerate(reads)}
    if params.place_repeats_randomly:
        # -placeRepeatsRandomly (Blasr.cpp:3041-3086): tied-best alignments
        # of a read are ordered uniformly at random (deterministic per seed)
        rng = np.random.default_rng(params.random_seed)
        tie = {id(a): rng.random() for a in out}
        out.sort(key=lambda a: (order.get(a.qname, 1 << 30), a.score, tie[id(a)]))
    else:
        out.sort(key=lambda a: (order.get(a.qname, 1 << 30), a.score))
    met.n_reads = len(reads)
    met.n_unmapped = len(unmapped)
    met.wall_seconds = _time.time() - t_run0
    LAST_RUN_METRICS = met
    return out, unmapped


def _paths_from_device(res) -> list[Optional[AlignmentPath]]:
    """Reassemble AlignmentPath objects from the compact device traceback."""
    out: list[Optional[AlignmentPath]] = []
    for i in range(len(res.sel_score)):
        if res.sel_score[i] >= 0 or res.nops[i] == 0:
            out.append(None)
            continue
        out.append(
            AlignmentPath(
                q_start=int(res.q_start[i]),
                q_end=int(res.q_end[i]),
                t_start=int(res.t_start[i]),
                t_end=int(res.t_end[i]),
                # ops materialize lazily from the packed walk output; the
                # native SAM assembly consumes the packed form directly.
                # emit_moves=False serving ships no move strings at all
                # (coordinate/stat output formats only)
                ops=None,
                packed=(
                    res.moves_packed[i]
                    if res.moves_packed.shape[1] else None
                ),
                packed_nops=int(res.nops[i]),
                score=int(res.sel_score[i]),
                n_match=int(res.n_match[i]),
                n_mismatch=int(res.n_mismatch[i]),
                n_ins=int(res.n_ins[i]),
                n_del=int(res.n_del[i]),
            )
        )
    return out


def _process_batch(mapper: Mapper, batch: ReadBatch) -> tuple[list[AlignmentRecord], list[str]]:
    return _finalize_batch(mapper, batch, mapper.map_batch(batch.codes, batch.lengths))


def _finalize_batch(
    mapper: Mapper, batch: ReadBatch, device_res
) -> tuple[list[AlignmentRecord], list[str]]:
    params = mapper.params
    seqdb = mapper.index.seqdb
    res = unpack_result(device_res, params.dp_candidates)

    scores = res.sel_score
    t0 = res.sel_t0.astype(np.int64)
    strand = res.sel_strand
    valid = res.sel_valid
    mapqv = res.mapqv

    qlens_sel = np.repeat(batch.lengths, params.best_n)
    paths = _paths_from_device(res)

    records: list[AlignmentRecord] = []
    mapped_reads: set[int] = set()
    B = batch.codes.shape[0]
    lens = seqdb.lengths()
    # (the reference's RemoveLowQualityAlignments truncates ITS sorted
    # list at the first score > maxScore — but that list is sorted by the
    # same score, so failures are always a suffix and truncation equals a
    # per-record filter; our rank order can interleave, so filtering each
    # record independently is the faithful behavior)
    genome_host = mapper.index.genome if params.best_n > 1 else None
    anchor_cache: dict = {}   # (batch row, strand) -> reference anchor list
    for i2, path in enumerate(paths):
        b = i2 // params.best_n
        if batch.indices[b] < 0:
            continue  # padding row
        if path is None or not valid[i2]:
            continue
        score = int(scores[i2])
        rank = i2 % params.best_n
        if rank >= 1 and genome_host is not None:
            # -bestn secondary admission + geometry, reference semantics:
            # each candidate interval's reported alignment is its SDPAlign
            # (Local, detailed) result and the -maxScore cut acts on THAT
            # score (AlignIntervals Blasr.cpp:1716-1724 ->
            # RemoveLowQualityAlignments :2618 truncation). A secondary
            # whose seed chain supports only part of the read scores far
            # above -maxScore there even though its best LOCAL subpath
            # (our DP score) passes — and when it IS admitted, the
            # reference's span follows the chain, not the full-window
            # local path. Primaries keep our local DP record (strictly
            # better scores; documented divergence).
            from blasr_jax.pipeline.secondary_refine import (
                blocks_to_ops, reference_anchor_list, revcomp_codes,
                sdp_interval_align, stats_from_blocks, sum_anchors_window)

            n_b = int(batch.lengths[b])
            qc = batch.codes[b, :n_b]
            if int(strand[i2]) == 1:
                qc = revcomp_codes(qc)
            t0_i = int(t0[i2])
            # PASS 1 — chain discovery: SDP Local on an unstretched window
            # around the device chain corners with end matching OFF
            # (prefix_len=0, so window-edge junk cannot seed the chain).
            # Its chain span reproduces the reference's interval corners
            # (the LIS chain the WeightedInterval carries).
            cd_i = int(res.sel_cd[i2])
            g_lo_ch = int(res.cand_tlo[b, cd_i])
            g_hi_ch = int(res.cand_thi[b, cd_i])
            g_mid = (g_lo_ch + g_hi_ch) // 2
            ci_w = int(seqdb.contig_of(min(max(g_mid, 0),
                                           seqdb.total_length - 1)))
            c_lo = int(seqdb.starts[ci_w])
            c_hi = c_lo + int(seqdb.lengths()[ci_w])
            w0_lo = max(g_lo_ch - 64, c_lo)
            w0_hi = min(g_hi_ch + 64, c_hi)
            sdp_kw = dict(
                word=params.sdp_tuple_size,
                match=params.match_score, mismatch=params.mismatch_score,
                ins=params.insertion_score, dele=params.deletion_score,
                indel_rate=params.indel_rate * 3,
                affine_open=params.affine_open,
                affine_extend=params.affine_extend,
            )
            _, b0 = sdp_interval_align(
                qc, genome_host[w0_lo:w0_hi], prefix_len=0, **sdp_kw
            )
            if not b0:
                continue
            q_lo0 = b0[0][0]
            q_hi0 = b0[-1][0] + b0[-1][2]
            t_lo0 = w0_lo + b0[0][1]
            t_hi0 = w0_lo + b0[-1][1] + b0[-1][2]
            # interval-formation gate (StoreLargestIntervals minSize:
            # SumAnchors over a readLen*(1+indelRate) window containing
            # the cluster must EXCEED minInterval, FindMaxInterval.h:479)
            L_int = int(n_b * (1 + params.indel_rate))
            ws_lo = max(min(t_lo0, t_hi0 - L_int), c_lo)
            ws_hi = min(max(t_hi0, t_lo0 + L_int), c_hi)
            sum_a = None
            if len(mapper.index.sa):    # FM-only indexes skip the gate
                akey = (b, int(strand[i2]))
                if akey not in anchor_cache:
                    anchor_cache[akey] = reference_anchor_list(
                        qc, genome_host, mapper.index.sa,
                        mapper.index.sa_kmers, mapper.index.k,
                        min_match=params.min_match_length,
                    )
                _aq_r, at_r, al_r = anchor_cache[akey]
                sum_a = sum_anchors_window(at_r, al_r, ws_lo, ws_hi)
            if sum_a is not None and sum_a <= params.min_interval:
                import os as _os
                if _os.environ.get("BLASR_SDP_DEBUG"):
                    print(f"[sdp2] {batch.names[b]} rank={rank} "
                          f"sum_anchors={sum_a} <= {params.min_interval}"
                          " (no interval)")
                continue
            # PASS 2 — the reference's aligned interval: chain corners
            # stretched by approximateMaxInsertionRate=1.3 times the
            # unaligned read prefix/suffix (Blasr.cpp:1247-1263), full
            # SDPAlign(Local, detailed, sdpPrefix=50). The corner-anchored
            # window is load-bearing: the small-word end matching over the
            # window's first/last 50 bases reproduces the reference's
            # junk-prefix/suffix score blow-up for partially supported
            # secondaries (the round-4 root cause).
            w_lo = max(int(t_lo0 - q_lo0 * 1.3), c_lo)
            w_hi = min(int(t_hi0 + (n_b - q_hi0) * 1.3), c_hi)
            window = genome_host[w_lo:w_hi]
            sdp_sc, sdp_blocks = sdp_interval_align(qc, window, **sdp_kw)
            import os as _os
            if _os.environ.get("BLASR_SDP_DEBUG"):
                print(f"[sdp2] {batch.names[b]} rank={rank} strand={int(strand[i2])} "
                      f"w=[{w_lo},{w_hi}) sum_a={sum_a} sc={sdp_sc} "
                      f"nb={len(sdp_blocks)} qlen={n_b}")
            if not sdp_blocks or sdp_sc > params.max_score:
                continue
            # geometry: keep our (better-scoring) record when it covers
            # the same span; adopt the reference's chain-derived span when
            # the two disagree (the guided-vs-free span tail)
            q_s2 = sdp_blocks[0][0]
            q_e2 = sdp_blocks[-1][0] + sdp_blocks[-1][2]
            t_s2 = w_lo + sdp_blocks[0][1] - t0_i
            t_e2 = w_lo + sdp_blocks[-1][1] + sdp_blocks[-1][2] - t0_i
            def _agree(lo1, hi1, lo2, hi2):
                ov = min(hi1, hi2) - max(lo1, lo2)
                return ov / max(hi1 - lo1, hi2 - lo2, 1) >= 0.9
            if not (
                _agree(path.q_start, path.q_end, q_s2, q_e2)
                and _agree(path.t_start, path.t_end, t_s2, t_e2)
            ):
                nm, nx, ni, nd = stats_from_blocks(
                    sdp_blocks, qc, window
                )
                from blasr_jax.pipeline.traceback import AlignmentPath

                path = AlignmentPath(
                    q_start=q_s2, q_end=q_e2,
                    t_start=t_s2, t_end=t_e2,
                    ops=blocks_to_ops(sdp_blocks),
                    score=sdp_sc,
                    n_match=nm, n_mismatch=nx, n_ins=ni, n_del=nd,
                )
                score = sdp_sc
        if score > params.max_score:
            continue
        if path.pct_similarity < params.min_pct_similarity:
            continue
        if path.pct_similarity > params.max_pct_identity:
            continue
        if path.n_aligned < params.min_align_length:
            continue
        if int(mapqv[i2]) < params.min_map_qv:
            continue
        g_start = int(t0[i2]) + path.t_start
        g_end = int(t0[i2]) + path.t_end
        if g_start < 0 or g_end > seqdb.total_length:
            continue
        ci = int(seqdb.contig_of(g_start))
        c_off = int(seqdb.starts[ci])
        c_len = int(lens[ci])
        ts_f = g_start - c_off
        te_f = g_end - c_off
        n = int(qlens_sel[i2])
        st = int(strand[i2])
        if st == 0:
            qs, qe = path.q_start, path.q_end
            ts, te = ts_f, te_f
        else:
            qs, qe = n - path.q_end, n - path.q_start
            ts, te = c_len - te_f, c_len - ts_f
        records.append(
            AlignmentRecord(
                qname=batch.names[b],
                tname=seqdb.names[ci],
                score=score,
                pct_similarity=round(path.pct_similarity, 4),
                qstrand=0,
                qstart=qs,
                qend=qe,
                qlength=n,
                tstrand=st,
                tstart=ts,
                tend=te,
                tlength=c_len,
                mapqv=int(mapqv[i2]),
                contig_index=ci,
                tstart_fwd=ts_f,
                tend_fwd=te_f,
                path=path,
                read_index=int(batch.indices[b]),
            )
        )
        mapped_reads.add(b)

    unmapped = [
        batch.names[b]
        for b in range(B)
        if batch.indices[b] >= 0 and b not in mapped_reads
    ]
    return records, unmapped
