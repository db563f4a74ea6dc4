"""Mapping parameters.

Mirrors the *semantics* of the reference parameter bag
(``alignment/MappingParameters.h`` in mchaisso/blasr: ``Init()`` defaults at
MappingParameters.h:192-361, ``MakeSane()`` normalization at :367-545) over a
frozen dataclass, plus the static shape bounds that the batched device
pipeline needs (band width, anchors cap, candidates cap, ...).

Scoring convention follows the reference: scores are *minimized*; match is
negative, mismatch/gap positive (SMRTDistanceMatrix in
``common/algorithms/alignment/ScoreMatrices.h:20-26``: match -5, mismatch +6,
vs-N 0; indel 5; affine open 50 / extend 0 at MappingParameters.h:338-340).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MappingParams:
    # ---- seeding / anchoring (reference: AnchorParameters) ----
    min_match_length: int = 14        # -minMatch (ref default 14)
    max_anchors_per_position: int = 8  # -maxAnchorsPerPosition (shape bound)
    anchor_stride: int = 1            # seed every Nth read position
                                      # (advanceExactMatches-style speedup)
    # ---- candidate interval selection ----
    n_candidates: int = 6             # -nCandidates (ref default 10)
    pval_type: int = 0                # -pvaltype: 0/1 log-pvalue, 2 size,
                                      # 3 legacy inverse-frequency
    n_dp_candidates: Optional[int] = None  # windows DP'd per read across both
                                      # strands (default: n_candidates)
    best_n: int = 1                   # -bestn (ref default 10; 1 = primary)
    indel_rate: float = 0.3           # -indelRate
    # ---- scoring (minimization; SMRT defaults) ----
    match_score: int = -5
    mismatch_score: int = 6
    insertion_score: int = 5          # gap in target (extra read base), -indel
    deletion_score: int = 5           # gap in read (missing read base)
    affine_open: int = 50             # -affineOpen
    affine_extend: int = 0            # -affineExtend
    score_matrix: Optional[tuple] = None  # -scoreMatrix: 25 ints, row-major
                                      # query x target over A C G T N
                                      # (StringToScoreMatrix.h:9-44)
    max_score: int = -200             # -maxScore: report only score <= this
    min_interval: int = 100           # -minInterval: minimum summed anchor
                                      # bases (noOvpLisNBases) for a
                                      # candidate interval; this fork
                                      # defaults to 100
                                      # (MappingParameters.h:348,
                                      # FindMaxInterval.h:832) — the gate
                                      # that keeps bare-repeat-match windows
                                      # out of the interval queue
    min_pct_similarity: float = 0.0   # -minPctIdentity
    max_pct_identity: float = 100.0   # -maxPctIdentity (screen out too-good)
    min_map_qv: int = 0               # -minMapQV output filter
    min_avg_qual: float = 0.0         # -minAvgQual FASTQ input filter
    forward_only: bool = False        # -forwardOnly: skip the RC strand
    samqv: Optional[tuple] = None     # -samqv: which QV tags to emit
    remove_contained: bool = False    # read-span RemoveContained gate on
                                      # -bestn emission. Reference default
                                      # is FALSE (removeContainedIntervals,
                                      # MappingParameters.h:350) — secondary
                                      # repeat placements whose read span is
                                      # contained in the primary's ARE
                                      # emitted at -bestn>1; -removeContained
                                      # and the -alignContigs preset
                                      # (MappingParameters.h:469) enable it
    min_align_length: int = 0         # -minAlnLength
    min_read_length: int = 50         # -minReadLength (ref default 50)
    place_repeats_randomly: bool = False  # -placeRepeatsRandomly
    random_seed: int = 0              # -randomSeed
    # ---- device shape bounds (static; chosen per batch bucket) ----
    max_read_len: int = 2048          # padded query length L
    band_width: int = 128             # DP band cells: a multiple of 32, one
                                      # warp's lanes (ops/banded_gpu.py)
    narrow_band: int = 64             # use this band for buckets with
                                      # L <= narrow_band_max (0 = off); the
                                      # drift-slope qoff schedule keeps the
                                      # narrow band centred (make_qoff_num)
    narrow_band_max: int = 1536       # longest bucket served by narrow_band
    candidate_win: int = 128          # diagonal window width for candidate
                                      # selection/weights (decoupled from
                                      # the DP band width)
    target_pad: int = 256             # extra target window beyond read length
    max_anchors_per_read: int = 512   # A: anchors kept per read-strand
    diag_bucket_log2: int = 8         # diagonal bin width = 256
    batch_size: int = 64              # reads per device batch
    dispatch_ahead: int = 8           # batches in flight (async pipeline depth)
    fetch_threads: int = 4            # concurrent device-to-host fetches
                                      # overlapping device compute (role of
                                      # the reference's writer-semaphore
                                      # pipeline)
    # ---- misc ----
    min_expand: int = 0               # -minExpand: starting anchor expand
                                      # level (each level shortens the
                                      # effective seed by one base, widening
                                      # every SA interval — Blasr.cpp:2263,
                                      # MapBySuffixArray.h:176-191)
    max_expand: int = 0               # -maxExpand: retry unmapped reads at
                                      # increasing expand levels up to this
                                      # (Blasr.cpp:2554-2578 do/while)
    sdp_tuple_size: int = 11          # -sdpTupleSize (SDP path)
    piecewise: bool = False           # -alignContigs/-piecewise long queries
    sensitive_retry: bool = False     # -useSensitiveSearch second pass
    ignore_qualities: bool = False    # -ignoreQualities (QV-aware scoring off)
    piecewise_max_gap: int = 100_000  # stitch gap cap (ref Blasr.cpp:1612)
    segment_length: int = 1024        # piecewise segment size; also bounds
                                      # band-trackable indel drift (W/2 over
                                      # the segment instead of the read)
    auto_segment: bool = True         # route reads > 1.5x segment_length
                                      # through the piecewise path
    direct_lut: Optional[bool] = None  # full-resolution 4^k prefix table for
                                      # the SA anchor search: lo/nh in two
                                      # gathers, no per-position bisection.
                                      # None = auto (on when 2k <= 28 and the
                                      # genome is >= 1 Mb; the table is
                                      # 4^k * 4 B of HBM, built on device)
    band_escalation: bool = True      # narrow-band escape hatch: after the
                                      # main pass, re-map reads the packed
                                      # narrow band visibly clipped (best
                                      # record below 80% similarity or 90%
                                      # query coverage) through the per-item
                                      # guided wide band and keep the better
                                      # score. This buys the reference's
                                      # every-read guided-band robustness
                                      # (GuidedAlign.h:279) at the cost of
                                      # re-mapping only the few flagged reads
                                      # (~1-7% depending on error profile;
                                      # measured in scripts/escalation_probe2
                                      # .py: catches 39/40 of the reads a
                                      # narrow-everywhere band newly breaks)
    guided_band: bool = False         # per-item anchor-chain band guides
                                      # (GuidedAlign.h:104 analogue): each
                                      # read's DP band follows its own knot
                                      # schedule instead of the shared
                                      # drift-slope line, so the full band
                                      # stays at base width at every length
    adaptive_cd: bool = False         # adaptive candidate depth: map with
                                      # ONE DP window per read, then re-map
                                      # only reads where a SECOND window
                                      # passed interval admission through
                                      # the full n_dp_candidates program.
                                      # Output is IDENTICAL to the flat
                                      # CD program by construction (an
                                      # unadmitted window contributes
                                      # nothing to selection or MAPQ), and
                                      # only ~10% of golden-corpus reads
                                      # carry a second admitted window
                                      # (scripts/calibrate_cd.py) — the
                                      # other 90% skip nearly half the
                                      # device pipeline. best_n == 1 only.
    exact_chain: bool = False         # rank candidate intervals by the
                                      # EXACT max-weight colinear chain
                                      # (GlobalChain.h:100-210, on-device
                                      # fori_loop weighted LIS, oracle-
                                      # tested vs global_chain_exact).
                                      # Measured on the golden corpus:
                                      # 99.70% agreement at 4.0k reads/s
                                      # vs the evidence-count default's
                                      # 99.80% at ~11k — the reference's
                                      # emergent placements are matched
                                      # BETTER by the count ranking
                                      # (blasrmc ranks by LIS p-values
                                      # over variable maximal-match
                                      # lengths, not pure chain size), so
                                      # the default stays the count.
    emit_moves: bool = True           # ship per-alignment 2-bit move
                                      # strings over the host link. m4
                                      # output needs only coordinates+stats
                                      # (already in sel_ints), so the plain
                                      # -m 4 CLI/bench turn this off and
                                      # skip ~577 B of packed moves per read.
                                      # Forced on when best_n > 1 (the
                                      # secondary SDP admission replays
                                      # path.ops); SAM/m0-m5/piecewise
                                      # consumers require it on.
    nproc: int = 1                    # host worker threads for IO/traceback
    ndevices: int = 1                 # devices used by the serving path:
                                      # 1 = default device, 0 = all visible,
                                      # N = first N (batch sharded over a 1-D
                                      # dp mesh, index replicated — §2.9)
    scale_map_qv_by_align_length: bool = False

    @property
    def dp_candidates(self) -> int:
        """Windows actually aligned per read (across strands)."""
        return self.n_dp_candidates or self.n_candidates

    @property
    def num_dp_steps(self) -> int:
        """Anti-diagonal count for the banded wavefront DP."""
        return self.max_read_len + self.target_len

    @property
    def target_len(self) -> int:
        """Padded target window length T."""
        return self.max_read_len + self.target_pad

    def with_read_len(self, max_read_len: int) -> "MappingParams":
        return dataclasses.replace(self, max_read_len=max_read_len)

    def band_width_for(self, read_len: int) -> int:
        """DP band for a bucket cap: narrow (packed) band when the drift
        schedule can track it; otherwise a full band that SCALES with the
        bucket so long reads keep the same relative slack. A straight-line
        drift schedule absorbs a read's mean indel drift but not its bursts
        (clustered stutter insertions); at PacBio CLR error rates the burst
        excursion grows with length, and a constant 128 band that is ample
        at 1 kb mis-starts 2.5-3 kb reads by 100-300 bp (measured on the
        published-CLR corpus: start-accuracy 0.958 -> 0.978 at band 256).
        The reference sidesteps this with a per-read anchor-chain guide
        (GuidedAlign.h:104); length-proportional banding is the schedule
        analogue until the kernel carries per-item piecewise guides."""
        if self.narrow_band and read_len <= self.narrow_band_max:
            return self.narrow_band
        if self.guided_band:
            # per-item anchor-chain guides track bursty drift, so the full
            # band stays at its base width at every length
            return self.band_width
        return max(self.band_width, 128 * -(-(read_len + 512) // 2048))

    def validate(self) -> None:
        if self.band_width <= 0 or self.band_width % 32 != 0:
            raise ValueError(
                "band_width must be a positive multiple of 32: the GPU DP "
                "holds the band in whole warps, one cell per lane")
        if self.narrow_band and self.narrow_band not in (32, 64, 128):
            raise ValueError("narrow_band must be 0, 32, 64 or 128")
        if not (1 <= self.min_match_length <= 30):
            # 2 bits/base: int32 keys to k=15, split int64 keys to k=30
            raise ValueError("min_match_length must be in [1, 30]")
        if self.n_dp_candidates and self.best_n > self.n_dp_candidates:
            raise ValueError(
                "best_n cannot exceed n_dp_candidates (the emission selects "
                "from the DP'd windows)")
        if self.best_n > self.n_candidates:
            raise ValueError("best_n must be <= n_candidates")


DEFAULT_PARAMS = MappingParams()
