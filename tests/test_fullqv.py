"""FullQVAlign forward probability: scan-form row solver vs per-cell
oracle, plus model sanity (FullQVAlign.h contract)."""

import numpy as np

from blasr_jax.io.batching import Read
from blasr_jax.ops.fullqv import _tracks, fullqv_align


def _cell_oracle(query, target):
    """Literal per-cell transcription of FullQVAlign.h:25-125
    (else-branches; log-space)."""
    q = np.asarray(query.codes, np.int16)
    t = np.asarray(target.codes, np.int16)
    Lq, Lt = len(q), len(t)
    ps_q, pi_q, pd_q = _tracks(query, Lq)
    ps_t, pi_t, pd_t = _tracks(target, Lt)
    P = np.zeros((Lq + 1, Lt + 1))
    for j in range(1, Lt + 1):
        P[0][j] = np.log(pi_t[j - 1]) + P[0][j - 1]
    for i in range(1, Lq + 1):
        P[i][0] = np.log(pi_q[i - 1]) + P[i - 1][0]
    for i in range(1, Lq + 1):
        for j in range(1, Lt + 1):
            if q[i - 1] == t[j - 1]:
                mp = (1 - ps_q[i - 1]) * (1 - ps_t[j - 1])
            else:
                mp = (ps_q[i - 1] / 3) * (1 - ps_t[j - 1]) + (
                    1 - ps_q[i - 1]
                ) * (ps_t[j - 1] / 3)
            m = np.exp(P[i - 1][j - 1]) * mp
            ins = (pi_q[i - 1] + pd_t[j - 1]) * np.exp(P[i - 1][j])
            dele = (pi_t[j - 1] + pd_q[i - 1]) * np.exp(P[i][j - 1])
            P[i][j] = np.log(m + ins + dele)
    return float(P[Lq][Lt])


def _mk(codes, seed=0, with_qvs=True):
    rng = np.random.default_rng(seed)
    n = len(codes)
    qvs = None
    if with_qvs:
        qvs = {
            "iq": rng.integers(8, 20, n).astype(np.uint8),
            "dq": rng.integers(8, 20, n).astype(np.uint8),
            "sq": rng.integers(10, 30, n).astype(np.uint8),
        }
    return Read("r", np.asarray(codes, np.uint8), None, 0, qvs=qvs)


def test_scan_matches_cell_oracle():
    rng = np.random.default_rng(3)
    for trial in range(4):
        a = _mk(rng.integers(0, 4, 30), seed=trial)
        b = _mk(rng.integers(0, 4, 25), seed=trial + 10)
        got = fullqv_align(a, b)
        ref = _cell_oracle(a, b)
        assert abs(got - ref) < 1e-9 * max(1.0, abs(ref)), (got, ref)


def test_identical_beats_mutated():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, 60)
    a = _mk(base, seed=1)
    same = _mk(base.copy(), seed=2)
    mut = base.copy()
    mut[::5] = (mut[::5] + 1) % 4
    worse = _mk(mut, seed=2)
    assert fullqv_align(a, same) > fullqv_align(a, worse)


def test_defaults_without_tracks():
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, 40)
    a = Read("a", base.astype(np.uint8), None, 0)
    b = Read("b", base.astype(np.uint8), None, 1)
    assert np.isfinite(fullqv_align(a, b))
