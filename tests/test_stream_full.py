"""Field-exact ObsData reconstruction from the record="full" feed.

The reference's product is observation views read every step
(include/pybind/vectorized.h:60-150: map, per-player piles, shop,
masks, resources, phase — include/api.h:84-129). Here the feed's
40-word records + reset keyframes must let a host mirror reproduce that
surface exactly: an XLA replay of the recorded actions provides the
per-step ground truth (bit-exact vs the kernel scan by construction),
and every field is compared at every step, across several mid-run
queued auto-resets.
"""
import jax
import numpy as np

from eldorado_tpu import stream as S
from eldorado_tpu import vec
from eldorado_tpu.core import engine as E

_vstep = jax.jit(jax.vmap(E.step_env))


def _cmp(recon, truth, t):
    tr = jax.device_get(truth)
    assert np.array_equal(recon.piles, np.asarray(tr.piles)), f"piles@{t}"
    assert np.array_equal(recon.shop, np.asarray(tr.shop_stock)), f"shop@{t}"
    assert np.array_equal(recon.storage,
                          np.asarray(tr.storage_masks)), f"storage@{t}"
    assert np.array_equal(recon.sel, np.asarray(tr.sel_mask)), f"sel@{t}"
    assert np.array_equal(recon.agent, np.asarray(tr.agent)), f"agent@{t}"
    assert np.array_equal(recon.phase, np.asarray(tr.phase)), f"phase@{t}"
    assert np.array_equal(recon.resources,
                          np.asarray(tr.resources)), f"resources@{t}"
    assert np.array_equal(recon.done, np.asarray(tr.done)), f"done@{t}"
    assert np.array_equal(recon.map_ids, np.asarray(tr.map_ids)), f"map@{t}"
    assert np.array_equal(recon.min_xy, np.asarray(tr.min_xy)), f"minxy@{t}"


def test_full_feed_reconstructs_obsdata_field_exact():
    n, chunk, n_chunks = 8, 40, 6
    states = vec.vec_reset(5, n, 4, 1, 0, 60)    # max_steps=60: mid-run ends
    rngs = vec.sampler_init(11, n)
    recon = S.ObsReconstructor(states)

    blocks = []
    _, _, episodes, cons = S.stream_rollout(
        states, rngs, chunk * n_chunks, chunk, block=n,
        deliver="ring", steps_per_push=chunk,
        record="full", consume=lambda r: blocks.append(r.copy()))
    assert episodes > 0, "workload must include mid-run auto-resets"
    assert cons.records == n * chunk * n_chunks
    assert len(blocks) == n_chunks
    recon.feat, recon.q_cap = cons.feat, cons.q_cap
    kf = dict(cons.keyframes)
    assert kf, "expected at least one reset keyframe"

    # XLA ground truth: replay the recorded actions step by step; at each
    # chunk boundary reset the finished envs (the queue covers every
    # finisher at Q = n, so reset_done == the queued semantics)
    truth = states
    for ci in range(n_chunks):
        rec = blocks[ci]                         # (chunk, n, 40)
        d = S.unpack_full(rec)
        for t in range(chunk):
            truth = _vstep(truth, d["actions"][t].astype(np.int32))
            recon.apply_step(rec[t])
            _cmp(recon, truth, (ci, t))
            assert not d["shop_overflow"][t].any()
            assert not d["res_overflow"][t].any()
        if ci in kf:
            recon.apply_reset(kf[ci])
            truth = vec.reset_done(truth)
            _cmp(recon, truth, (ci, "reset"))
        else:
            assert not bool(np.asarray(truth.done).any())

    # the reconstructed surface exposes the reference ObsData layout
    obs = recon.observations()
    assert obs["map"].shape == (n, 48, 48, 7)
    assert obs["piles"].shape == (n, 4, 5, 21)
    assert obs["action_masks"].shape == (n, 4, 92)
    assert obs["shop"].shape == (n, 18)


def test_full_records_superset_of_compact():
    """Words 0..4 of a full record equal the compact record bit-for-bit
    (same scan, same draws): compact consumers read a full stream."""
    n, T = 8, 30
    states = vec.vec_reset(9, n, 4, 1, 0, 100000)
    rngs = vec.sampler_init(3, n)
    progs = vec._kernel_programs(states, "storage", n)
    bctx, bdyn, brngs = progs.block_in(states, rngs)
    _, _, _, _, _, tj_c = progs.run_q(bctx, bdyn, brngs,
                                      progs.qstate_init(), T, "packed")
    bctx, bdyn, brngs = progs.block_in(states, rngs)
    _, _, _, _, _, tj_f = progs.run_q(bctx, bdyn, brngs,
                                      progs.qstate_init(), T, "full")
    c = np.asarray(progs.unblock_packed(tj_c))
    f = np.asarray(progs.unblock_packed(tj_f))
    assert c.shape == (T, n, 5) and f.shape == (T, n, 40)
    assert np.array_equal(f[..., :5], c)
