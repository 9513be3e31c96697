"""The packed 4-word map read (engine.ball_words) and its per-cell table
(pack_ball_word_table) must agree exactly: the table is what the kernel
rollout gathers per step, ball_words is what the XLA path (and the golden
replays) compute — any divergence silently corrupts kernel trajectories.
Also round-trips the 5-bit cell-type codec against every terrain triple.
"""
import jax
import jax.numpy as jnp
import numpy as np

from eldorado_tpu import vec
from eldorado_tpu.core import engine as E


def test_w3_fold_jit_parity():
    """Canary for an XLA wrong-code bug (jax 0.9.0, seen on more than one
    backend; chip_smoke.py runs it on the GPU): an i32 or/sum fold SEEDED
    with (end << 30) silently drops the << 20 term under jit(vmap) (jit
    and eager disagree). The engine's w3 packers fold the id fields
    first and OR the end bit last, which compiles correctly — this test
    pins jit == eager for that formulation on random data."""
    rng = np.random.default_rng(0)
    pids = jnp.asarray(rng.integers(0, 32, (8, 19)), np.int32)
    pend = jnp.asarray(rng.integers(0, 2, (8,)), np.int32)

    def fold(pids, pend):
        w3 = jnp.zeros_like(pids[..., 0])
        for i in range(6):
            w3 = w3 | (pids[..., 1 + i] << (5 * i))
        return w3 | (pend << 30)

    eager = np.asarray(jax.vmap(fold)(pids, pend))
    jitted = np.asarray(jax.jit(jax.vmap(fold))(pids, pend))
    want = np.asarray(pend) << 30
    for i in range(6):
        want = want | (np.asarray(pids)[:, 1 + i] << (5 * i))
    assert (eager == want).all()
    assert (jitted == want).all()


def test_cell_type_codec_roundtrip():
    req, nr, end = (np.array(t) for t in zip(*E._CELL_TRIPLES))
    ids = np.asarray(E.cell_type_ids(req, nr, end))
    assert sorted(ids) == list(range(E.N_CELL_TYPES))
    r2, n2, e2 = (np.asarray(x) for x in E._decode_cells(ids))
    assert (r2 == req).all() and (n2 == nr).all() and (e2 == end).all()
    # sentinel: the empty cell decodes to (5, 0, 0) at id 0
    assert E._CELL_TRIPLES[0] == (5, 0, 0)


def test_mask_word_packing_roundtrip():
    """pack_mask/unpack_mask round-trip on adversarial patterns, and the
    sign-safe row select: bits 31/63 of a packed row land in i32 sign
    positions, where a masked-max row select silently corrupts."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        bits = rng.random(E.MASK_LEN) < rng.random()
        back = np.asarray(E.unpack_mask(E.pack_mask(jnp.asarray(bits))))
        assert (back == bits).all()
    # all-ones row exercises both sign bits
    ones = np.ones(E.MASK_LEN, bool)
    rows = jnp.tile(E.pack_mask(jnp.asarray(ones))[None], (4, 1))
    for p in range(4):
        got = np.asarray(E.unpack_mask(E._wrow(rows, jnp.int32(p))))
        assert got.all(), p


def test_ball_word_table_matches_ball_words():
    """Gathering the table row at the agent's cell == ball_words, and the
    w3 column at every player's cell == their w3_cache row, across
    seeds/piece-counts (the stencil-equivalence argument in
    pack_ball_word_table's docstring, verified)."""
    for seed, pieces, diff in [(9, 3, 1), (21, 5, 2)]:
        s = vec.vec_reset(seed, 8, 4, pieces, diff, 100000)
        tabs = np.asarray(jax.vmap(E.pack_ball_word_table)(s.map_ids))
        # tile-packed (n, 72, 128) -> logical (n, 2304, 4) cell rows
        tabs = tabs.reshape(tabs.shape[0], 2304, 4)
        words = [np.asarray(w) for w in jax.vmap(E.ball_words)(s)]
        cache = np.asarray(s.w3_cache)
        agent = np.asarray(s.agent)
        npl = np.asarray(s.n_players)
        xy = np.asarray(s.player_xy)
        mn = np.asarray(s.min_xy)

        def cell(e, who):
            d = xy[e, who] - mn[e]
            return ((d[0] >> 1) + 1) * E.GRIDSIZE + ((d[1] >> 1) + 1)

        for e in range(8):
            c = cell(e, agent[e])
            for w_i in range(4):
                assert tabs[e, c, w_i] == words[w_i][e], (seed, e, w_i)
            # reset filled every live player's w3_cache row with the
            # table's w3 column at their position
            for j in range(int(npl[e])):
                assert cache[e, j] == tabs[e, cell(e, j), 3], (seed, e, j)


def test_ball_words_decode_matches_ball_cells():
    """Unpacking the packed words reproduces _ball_cells' rows for the
    agent (all 19 cells) and the next agent (the 6 one-hop cells + own
    end flag) — the full read set of the step."""
    s = vec.vec_reset(5, 4, 4, 3, 1, 100000)
    req, nr, end = (np.asarray(x) for x in jax.vmap(E._ball_cells)(s))
    w = jax.vmap(E.ball_words)(s)
    agent = np.asarray(s.agent)
    q = np.where(agent + 1 >= np.asarray(s.n_players), 0, agent + 1)
    pids = jax.vmap(E._ball_p_ids)(w[0], w[1], w[2])
    pr, pn, pe = (np.asarray(x) for x in E._decode_cells(pids))
    # the next agent's pseudo row decodes from their w3_cache entry
    w3q = jnp.take_along_axis(s.w3_cache, jnp.asarray(q)[:, None],
                              axis=1)[:, 0]
    qr, qn, qe = (np.asarray(x) for x in jax.vmap(E._ball_q_row)(w3q))
    for e in range(4):
        a = agent[e]
        assert (pr[e] == req[e, a]).all()
        assert (pn[e] == nr[e, a]).all()
        assert (pe[e] == end[e, a]).all()
        assert (qr[e, 1:7] == req[e, q[e], 1:7]).all()
        assert (qn[e, 1:7] == nr[e, q[e], 1:7]).all()
        assert (qe[e, 1:7] == end[e, q[e], 1:7]).all()
        assert qe[e, 0] == end[e, q[e], 0]
