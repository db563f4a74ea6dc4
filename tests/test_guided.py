"""Per-item guided band schedules (GuidedAlign.h:104 per-read guide role):
knot construction, per-item qoff expansion, oracle DP with (S, I) schedules,
and the knot-walk equality with the table walk."""

import jax.numpy as jnp
import numpy as np
import pytest

from blasr_jax.ops.banded_align import (
    KNOT_SPACING,
    AlignScores,
    banded_align,
    make_qoff,
    make_qoff_knots,
    n_knots,
    qoff_from_knots,
    QOFF_NUM_HALF,
)

SC = AlignScores()


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def _mutate(rng, seg, rate=0.05):
    seg = seg.copy()
    mut = rng.random(len(seg)) < rate
    seg[mut] = (seg[mut] + rng.integers(1, 4, mut.sum())) % 4
    return seg


def test_per_item_qoff_equals_shared_bitwise(rng):
    """(S, I) schedules that replicate the shared (S,) schedule must give
    bit-identical scores, best cells and arrow words."""
    I, L, T, W = 4, 192, 256, 128
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = np.full((I, T), 5, np.uint8)
    for i in range(I):
        Tc[i, : L] = _mutate(rng, Q[i])
        Tc[i, L:] = rng.integers(0, 4, T - L)
    qlen = np.full(I, L, np.int32)
    tlo = np.zeros(I, np.int32)
    thi = np.full(I, T, np.int32)
    qoff = make_qoff(L, T, W, (T - L) // 2)
    r1 = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.asarray(tlo), jnp.asarray(thi), jnp.asarray(qoff),
        scores=SC, with_traceback=True, band_width=W,
    )
    qoff2 = jnp.broadcast_to(jnp.asarray(qoff)[:, None], (len(qoff), I))
    r2 = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.asarray(tlo), jnp.asarray(thi), qoff2,
        scores=SC, with_traceback=True, band_width=W,
    )
    np.testing.assert_array_equal(np.asarray(r1.score), np.asarray(r2.score))
    np.testing.assert_array_equal(np.asarray(r1.best_a), np.asarray(r2.best_a))
    np.testing.assert_array_equal(np.asarray(r1.best_w), np.asarray(r2.best_w))
    np.testing.assert_array_equal(
        np.asarray(r1.arrows), np.asarray(r2.arrows)
    )


def test_knot_schedule_invariants(rng):
    """Knots from noisy anchors: expanded schedule has per-step deltas in
    {0, 1} and stays inside [0, L - W]."""
    I, A, L, T, W = 8, 32, 1024, 1536, 64
    S = L + T - 1
    aq = np.sort(rng.integers(0, L, (I, A)), axis=1).astype(np.int32)
    # drifting chain: t = q + drift, plus jitter and outlier noise
    drift = rng.integers(-60, 60, (I, 1))
    at_loc = aq + drift + rng.integers(-10, 10, (I, A))
    a_anchor = aq + at_loc
    v_anchor = aq - W // 2
    mask = rng.random((I, A)) < 0.8
    knots = make_qoff_knots(
        jnp.asarray(a_anchor), jnp.asarray(v_anchor), jnp.asarray(mask),
        S, L, W, diag=(T - L) // 2, num=QOFF_NUM_HALF,
    )
    assert knots.shape == (I, n_knots(S))
    qoff2 = np.asarray(qoff_from_knots(knots, S))
    assert qoff2.shape == (S, I)
    d = np.diff(qoff2, axis=0)
    assert d.min() >= 0 and d.max() <= 1
    assert qoff2.min() >= 0 and qoff2.max() <= L - W
    kn = np.asarray(knots)
    assert (np.diff(kn, axis=1) <= KNOT_SPACING).all()


def test_guided_band_recovers_bursty_alignment(rng):
    """A read whose middle carries an 80-base insertion burst walks off a
    shared straight-line W=64 band, but a per-item knot schedule built from
    anchors on both sides of the burst holds the path: the guided narrow
    band must reproduce the wide-band (W=256) score."""
    W = 64
    Lg = 900
    tpl = rng.integers(0, 4, Lg).astype(np.uint8)
    burst = rng.integers(0, 4, 80).astype(np.uint8)
    q = np.concatenate([tpl[:450], burst, tpl[450:]])
    L = len(q)          # 980
    pad2 = 128
    T = L + 2 * pad2
    t = np.full(T, 5, np.uint8)
    t[pad2 : pad2 + Lg] = tpl
    t[:pad2] = rng.integers(0, 4, pad2)
    t[pad2 + Lg :] = rng.integers(0, 4, T - pad2 - Lg)
    S = L + T - 1
    Q = q[None, :]
    Tc = t[None, :]
    qlen = np.array([L], np.int32)
    tlo = np.zeros(1, np.int32)
    thi = np.array([T], np.int32)

    # wide-band reference score
    qoff_w = make_qoff(L, T, 256, pad2)
    r_wide = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.asarray(tlo), jnp.asarray(thi), jnp.asarray(qoff_w),
        scores=SC, band_width=256,
    )
    # shared straight-line narrow band misses the burst
    qoff_n = make_qoff(L, T, W, pad2)
    r_shared = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.asarray(tlo), jnp.asarray(thi), jnp.asarray(qoff_n),
        scores=SC, band_width=W,
    )
    # anchors every 64 bases on the true alignment path (skip the burst)
    aq_list, at_list = [], []
    for p in range(0, Lg - 16, 64):
        qp = p if p < 450 else p + 80    # query coord of template base p
        aq_list.append(qp)
        at_list.append(pad2 + p)
    aq = np.asarray(aq_list, np.int32)[None, :]
    at = np.asarray(at_list, np.int32)[None, :]
    knots = make_qoff_knots(
        jnp.asarray(aq + at), jnp.asarray(aq - W // 2),
        jnp.ones_like(aq, bool), S, L, W, diag=pad2, num=QOFF_NUM_HALF,
    )
    qoff2 = qoff_from_knots(knots, S)
    r_guided = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.asarray(tlo), jnp.asarray(thi), qoff2,
        scores=SC, band_width=W,
    )
    wide = int(np.asarray(r_wide.score)[0])
    shared = int(np.asarray(r_shared.score)[0])
    guided = int(np.asarray(r_guided.score)[0])
    # the template aligns fully: score ~ Lg*match + one 80-base gap
    assert wide < 0.8 * Lg * SC.match
    assert guided == wide, (guided, wide)
    assert shared > wide + 300, (shared, wide)  # shared band really fails


def test_walk_knots_matches_table_walk(rng):
    """The knot-walk (per-item lerp) must reproduce the table walk when all
    items share the schedule."""
    from blasr_jax.ops.traceback_device import walk_arrows_device

    I, L, W = 4, 256, 64
    pad2 = 64
    T = L + 2 * pad2
    S = L + T - 1
    Q = np.zeros((I, L), np.uint8)
    Tc = np.full((I, T), 5, np.uint8)
    for i in range(I):
        tpl = rng.integers(0, 4, L).astype(np.uint8)
        Tc[i, pad2 : pad2 + L] = tpl
        Tc[i, :pad2] = rng.integers(0, 4, pad2)
        Tc[i, pad2 + L :] = rng.integers(0, 4, pad2)
        Q[i] = _mutate(rng, tpl, 0.08)
    qlen = np.full(I, L, np.int32)
    tlo = np.zeros(I, np.int32)
    thi = np.full(I, T, np.int32)

    # per-item knots replicating the shared line
    a_anchor = np.stack([np.arange(0, S, 97, dtype=np.int32)] * I)
    # v on the shared centre line
    v_anchor = ((a_anchor - pad2) // 2 - W // 2).astype(np.int32)
    knots = make_qoff_knots(
        jnp.asarray(a_anchor), jnp.asarray(v_anchor),
        jnp.ones_like(a_anchor, bool), S, L, W,
        diag=pad2, num=QOFF_NUM_HALF,
    )
    qoff2 = qoff_from_knots(knots, S)
    res = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.asarray(tlo), jnp.asarray(thi), qoff2,
        scores=SC, with_traceback=True, band_width=W,
    )
    tb_knots = walk_arrows_device(
        res.arrows, qoff2[:, 0], res.best_a, res.best_w, res.score,
        jnp.asarray(Q), jnp.asarray(Tc), qoff_knots=knots,
    )
    # table walk over the same per-item-constant schedule
    tb_table = walk_arrows_device(
        res.arrows, qoff2[:, 0], res.best_a, res.best_w, res.score,
        jnp.asarray(Q), jnp.asarray(Tc),
    )
    for f in tb_knots._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(tb_knots, f)),
            np.asarray(getattr(tb_table, f)), err_msg=f,
        )
