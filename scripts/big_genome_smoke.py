#!/usr/bin/env python
"""200 Mb genome smoke test: index build + mapping accuracy at scale."""
import os, sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from blasr_jax.index.artifacts import build_index_from_arrays, GenomeIndex
from blasr_jax.io.seqdb import SeqDB
from blasr_jax.params import MappingParams
from blasr_jax.pipeline.runner import run_mapping
from blasr_jax.sim import simulate_reads, parse_truth

G = 200_000_000
rng = np.random.default_rng(3)
genome = rng.integers(0, 4, G).astype(np.uint8)
starts = np.linspace(0, G, 11).astype(np.int64)
seqdb = SeqDB([f"chr{i}" for i in range(10)], starts, ["0"*32]*10)
index = build_index_from_arrays(genome, seqdb, k=15)
print("index ready", flush=True)
for mean_len in (500, 1000):
    reads, truth = simulate_reads(genome, 256, mean_len=mean_len, seed=5)
    params = MappingParams(batch_size=64, max_read_len=3072, n_candidates=4,
                           best_n=1, min_match_length=15)
    recs, unm = run_mapping(index, reads, params)
    byname={}
    for r in recs:
        c=byname.get(r.qname)
        if c is None or r.score<c.score: byname[r.qname]=r
    n_ok=0; n_strand=0
    for rd in reads:
        rec=byname.get(rd.name)
        if rec is None: continue
        s,e,st=parse_truth(rd.name)
        g_start = int(seqdb.starts[rec.contig_index]) + rec.tstart_fwd
        if rec.tstrand==st:
            n_strand+=1
            if abs(g_start-s)<100: n_ok+=1
    print(f"mean_len={mean_len}: correct {n_ok}/256 strand-ok {n_strand}/256 unmapped {len(unm)}", flush=True)
