"""Time the banded DP on the GPU with XLA's scan and with the CUDA kernel.

    python scripts/dp_compare.py [--out chiprun_out/dp_compare] [--reps 5]

At the bench operating point (bench.py: 4.6 Mb genome, 2,000 reads,
B = 256, two DP windows per read, W = 32):
  * the DP alone, I = 512 items at L = 1,024 and 3,328;
  * ``_map_batch_wire`` per batch for the 1,024 and 3,328 buckets;
  * ``run_mapping`` reads/s over the whole corpus, in the order
    xla, cuda, cuda, xla;
  * one profiler trace of a steady batch per DP (written to a temporary
    directory), reduced to device time per kernel name, the gathers among
    them, and the device's busy time in the traced window.
Needs a GPU. Prints one line per measurement and writes them as JSON.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(fn, reps):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)) * 1e3, [round(t * 1e3, 3) for t in ts]


def reduce_trace(trace_dir: str) -> dict:
    """Device time per kernel name in the newest trace under trace_dir."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    pd = ProfileData.from_file(path)
    per_name: dict = {}
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                d = per_name.setdefault(ev.name, [0.0, 0])
                d[0] += ev.duration_ns / 1e6
                d[1] += 1
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "top": [(n, round(ms, 3), c) for n, (ms, c) in top[:25]],
        "gathers": [(n, round(ms, 3), c) for n, (ms, c) in top if "gather" in n.lower()],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "dp_compare"))
    ap.add_argument("--reps", type=int, default=5)
    opts = ap.parse_args()

    import jax

    import bench
    from chip_smoke import _dp_inputs
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import batch_reads, read_records
    from blasr_jax.ops.banded_align import banded_align
    from blasr_jax.ops.banded_gpu import banded_align_gpu
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline import mapper as mp
    from blasr_jax.pipeline.runner import run_mapping

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    os.makedirs(opts.out, exist_ok=True)
    res: dict = {"card": card, "device_kind": dev.device_kind}

    def log(key, val):
        res[key] = val
        print(f"{key}: {json.dumps(val)}", flush=True)

    log("card", card)
    rng = np.random.default_rng(7)
    for L in (1024, 3328):
        args, sc = _dp_inputs(rng, 512, L, L + 256, 32, "shared")
        for name, fn in (
            ("xla", lambda: banded_align(*args, scores=sc, with_traceback=True,
                                         band_width=32)),
            ("cuda", lambda: banded_align_gpu(*args, scores=sc, band_width=32)),
        ):
            first, med, ts = timed(fn, opts.reps)
            log(f"dp_alone_L{L}_W32_{name}", {"first_s": round(first, 3),
                                              "median_ms": round(med, 3), "ms": ts})

    bench.ensure_corpus()
    reads = read_records(bench.READS_FA)
    params = MappingParams(
        batch_size=256, max_read_len=3328, n_candidates=4, n_dp_candidates=2,
        anchor_stride=4, max_anchors_per_read=128, narrow_band=32,
        narrow_band_max=3328, emit_moves=False,
    )
    index = load_index(bench.GENOME_FA, k=14)
    mapper = mp.Mapper(index, params)
    di = mapper.device_index
    batches = {}
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        batches.setdefault(b.codes.shape[1], b)
    for L in (1024, 3328):
        b = batches[L]
        codes, lengths = jax.device_put(b.codes), jax.device_put(b.lengths)
        for dp in ("xla", "cuda"):
            def step(dp=dp):
                return mp._map_batch_wire(
                    codes, lengths, di.genome_pad, di.arrays, di.starts, None,
                    params=params, pad=di.pad, k=di.k, genome_len=di.genome_len,
                    dp=dp, index_kind=di.kind, fm_n=di.fm_n,
                    lut_meta=di.lut_meta, mesh=None,
                )
            first, med, ts = timed(step, opts.reps)
            log(f"map_batch_L{L}_{dp}", {"compile_and_first_s": round(first, 2),
                                         "median_ms": round(med, 3), "ms": ts})
            tdir = tempfile.mkdtemp(prefix=f"trace_L{L}_{dp}_")
            with jax.profiler.trace(tdir):
                jax.block_until_ready(step())
            log(f"trace_L{L}_{dp}", reduce_trace(tdir))

    for dp in ("xla", "cuda", "cuda", "xla"):
        mp.DP_IMPLS["gpu"] = dp
        run_mapping(index, reads, params)  # warm: every bucket compiled
        t0 = time.perf_counter()
        recs, _ = run_mapping(index, reads, params)
        wall = time.perf_counter() - t0
        log(f"run_mapping_{dp}", {"reads_per_s": round(len(reads) / wall, 2),
                                  "wall_s": round(wall, 3), "records": len(recs)})
    mp.DP_IMPLS["gpu"] = "cuda"
    log("peak_bytes_in_use", dev.memory_stats().get("peak_bytes_in_use"))
    with open(os.path.join(opts.out, "dp_compare.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
