"""OneGap (deletion-SV) alignment: breakpoint recovery + optimality.

Contract from reference OneGapAlignment.h:18 — whole query globally aligned
to left ++ free-long-gap ++ right; gap close consumes a query base as a
(mis)match.
"""

import numpy as np
import pytest

from blasr_jax.ops.banded_align import AlignScores
from blasr_jax.ops.onegap import _global_dp, onegap_align
from blasr_jax.pipeline.traceback import OP_D, OP_I, OP_M

SC = AlignScores()


def _replay_cost(res, q, left, right, distance):
    """Score implied by the emitted ops with the long-gap run free."""
    full_t = np.concatenate([left, np.full(distance, 4, np.uint8), right])
    ops = res.path.ops
    qpos = tpos = 0
    cost = 0
    in_gap_run = np.zeros(len(ops), bool)
    # mark the free gap run: gap_len D ops starting at target gap_t_start
    if res.gap_len:
        tsteps = np.cumsum(ops != OP_I) - (ops != OP_I)
        started = False
        count = 0
        for idx, op in enumerate(ops):
            if (not started and op == OP_D and tsteps[idx] == res.gap_t_start
                    and count == 0):
                started = True
            if started and op == OP_D and count < res.gap_len:
                in_gap_run[idx] = True
                count += 1
            elif started:
                break
    for idx, op in enumerate(ops):
        if op == OP_M:
            qc, tc = int(q[qpos]), int(full_t[tpos])
            if qc == tc and qc < 4:
                cost += SC.match
            elif qc >= 4 or tc >= 4:
                cost += SC.n_score
            else:
                cost += SC.mismatch
            qpos += 1
            tpos += 1
        elif op == OP_I:
            cost += SC.insertion
            qpos += 1
        else:
            if not in_gap_run[idx]:
                cost += SC.deletion
            tpos += 1
    assert qpos == len(q) and tpos == len(full_t)
    return cost


def test_exact_breakpoint():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 4, 60).astype(np.uint8)
    b = rng.integers(0, 4, 50).astype(np.uint8)
    q = np.concatenate([a, b])
    # target: a ++ 300-base deletion ++ b, windows larger than the halves
    pad_l = rng.integers(0, 4, 20).astype(np.uint8)
    pad_r = rng.integers(0, 4, 20).astype(np.uint8)
    left = np.concatenate([a, pad_l])
    right = np.concatenate([pad_r, b])
    res = onegap_align(q, left, right, 300, SC)
    assert res.score == 110 * SC.match
    assert res.split_q == 60  # gap closes right where b starts
    assert res.gap_len == 20 + 300 + 20
    assert res.gap_t_start == 60
    assert res.path.n_match == 110


def test_score_matches_replayed_ops():
    rng = np.random.default_rng(11)
    for trial in range(8):
        q = rng.integers(0, 4, 40).astype(np.uint8)
        left = rng.integers(0, 4, 30).astype(np.uint8)
        right = rng.integers(0, 4, 25).astype(np.uint8)
        res = onegap_align(q, left, right, 100, SC)
        assert res.score == _replay_cost(res, q, left, right, 100)


def _oracle(q, left, right, distance):
    """Brute-force min over split (i, jl, jr): independent recombination."""
    qn, ln, rn = len(q), len(left), len(right)
    HL = _global_dp(q, left, SC)
    best = (ln + distance + rn) * SC.deletion + qn * SC.insertion  # all-indel
    for i in range(qn):
        for jl in range(ln + 1):
            for jr in range(rn):
                qc, tc = int(q[i]), int(right[jr])
                sub = SC.match if qc == tc else SC.mismatch
                tail = _global_dp(q[i + 1 :], right[jr + 1 :], SC)[-1, -1]
                v = HL[i, jl] + sub + int(tail)
                if v < best:
                    best = v
    return best


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_optimal_vs_bruteforce(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, 10).astype(np.uint8)
    left = rng.integers(0, 4, 7).astype(np.uint8)
    right = rng.integers(0, 4, 6).astype(np.uint8)
    res = onegap_align(q, left, right, 50, SC)
    assert res.score == _oracle(q, left, right, 50)


def test_no_gap_needed():
    """Query aligns entirely within left+right with no benefit from the gap
    beyond crossing the mandatory distance."""
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, 30).astype(np.uint8)
    res = onegap_align(q, q[:18].copy(), q[18:].copy(), 40, SC)
    assert res.score == 30 * SC.match
    assert res.gap_len == 40
    assert res.path.n_match == 30


def test_cli_onegap(tmp_path, capsys):
    from blasr_jax.cli.tools import main
    from blasr_jax.io.fasta import write_fasta

    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, 80).astype(np.uint8)
    b = rng.integers(0, 4, 70).astype(np.uint8)
    gap = rng.integers(0, 4, 400).astype(np.uint8)
    q = np.concatenate([a, b])
    t = np.concatenate([a, gap, b])
    write_fasta(str(tmp_path / "q.fa"), [("query", q)])
    write_fasta(str(tmp_path / "t.fa"), [("target", t)])
    rc = main(["onegap", str(tmp_path / "q.fa"), str(tmp_path / "t.fa")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "score" in out and "gap" in out
    assert f"score {150 * SC.match}" in out
