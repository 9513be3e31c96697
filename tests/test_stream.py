"""The per-step learner feed (eldorado_tpu.stream).

The packed records streamed off the kernel scan must carry exactly the
values the XLA rollout produces — action, reward, done, agent, selected
mask words, resources, phase, per step — and the device -> ring ->
consumer-thread pipeline must deliver every record (reference analogue:
the zero-copy observation views read every step,
include/pybind/vectorized.h:60-150, pytest/test_vec_env.py:97-112).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eldorado_tpu import stream, vec
from eldorado_tpu.core import engine as E


def _native_or_skip():
    from eldorado_tpu import native
    if not native.available():
        pytest.skip("native toolchain unavailable")


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    nb, block = 2, 8
    bact = jnp.asarray(rng.integers(0, 22, (nb, 5, block)), jnp.int32)
    bdone = jnp.asarray(rng.integers(0, 2, (nb, 1, block)), jnp.int32)
    brew = jnp.asarray(rng.integers(-4, 5, (nb, 4, block)), jnp.float32)
    bagent = jnp.asarray(rng.integers(0, 4, (nb, 1, block)), jnp.int32)
    bsel = jnp.asarray(rng.integers(-(1 << 31), 1 << 31,
                                    (nb, 3, block)), np.int64).astype(
                                        jnp.int32)
    bres = jnp.asarray(
        np.stack([rng.integers(0, 4, (nb, block)),
                  rng.integers(0, 4, (nb, block)),
                  rng.integers(0, 41, (nb, block)) * 0.5], axis=1),
        jnp.float32)
    bphase = jnp.asarray(rng.integers(0, 3, (nb, 1, block)), jnp.int32)
    packed = stream.pack_step_blocked(bact, bdone, brew, bagent, bsel,
                                      bres, bphase)
    assert packed.shape == (nb, stream.RECORD_WORDS, block)
    # blocked -> env-major records
    rec = np.moveaxis(np.asarray(packed), 1, 2).reshape(-1, 5)
    got = stream.unpack_records(rec)
    def em(x):  # (nb, f, block) -> (n, f)
        return np.moveaxis(np.asarray(x), 1, 2).reshape(
            -1, x.shape[1])
    assert (got["actions"] == em(bact)).all()
    assert (got["done"] == (em(bdone)[:, 0] != 0)).all()
    assert (got["agent"] == em(bagent)[:, 0]).all()
    assert (got["phase"] == em(bphase)[:, 0]).all()
    assert (got["rewards"] == em(brew)).all()
    assert (got["resources"] == em(bres)).all()
    assert (got["sel_words"] == em(bsel)).all()


def test_stream_matches_xla_traj():
    """Reset-free horizon: every streamed record equals the XLA rollout's
    per-step surface, field by field."""
    _native_or_skip()
    n, T = 8, 80
    s0 = vec.vec_reset(5, n, 4, 3, 0, 100000)
    r0 = vec.sampler_init(11, n)
    sK, rK, eps, consumer = stream.stream_rollout(
        s0, r0, T, chunk=40, block=8, steps_per_push=20)
    assert eps == 0
    assert consumer.records == n * T

    collected = []
    sK2, rK2, eps2, c2 = stream.stream_rollout(
        s0, r0, T, chunk=40, block=8, steps_per_push=20,
        consume=lambda r: collected.append(r.copy()))
    rec = np.concatenate(collected)          # (T, n, 5)
    assert rec.shape == (T, n, 5)
    got = stream.unpack_records(rec)

    sx, rx, traj = vec.rollout(s0, r0, T, "storage", "none")
    actions, done, rewards, agent, sel, res, phase = (
        np.asarray(t) for t in traj)
    assert (got["actions"] == actions).all()
    assert (got["done"] == done).all()
    assert (got["agent"] == agent).all()
    assert (got["phase"] == phase).all()
    assert (got["rewards"] == rewards).all()
    assert (got["resources"] == res).all()
    assert (got["sel_words"] == sel).all()
    # final states agree too
    for name in E.EnvState._fields:
        assert (np.asarray(getattr(sK2, name))
                == np.asarray(getattr(sx, name))).all(), name


def test_device_consumer_matches_host():
    """deliver="device" folds the same records on device: the demo stats
    consumer agrees with host-side computation from the ring records."""
    _native_or_skip()
    n, T = 8, 80
    s0 = vec.vec_reset(5, n, 4, 3, 0, 100000)
    r0 = vec.sampler_init(11, n)
    collected = []
    stream.stream_rollout(
        s0, r0, T, chunk=40, block=8, steps_per_push=20,
        consume=lambda r: collected.append(r.copy()))
    rec = np.concatenate(collected)
    got = stream.unpack_records(rec)

    sD, rD, epsD, carry = stream.stream_rollout(
        s0, r0, T, chunk=40, block=8, deliver="device")
    steps, eps, ret, hist = (np.asarray(x) for x in carry)
    assert steps == n * T
    assert eps == got["done"].sum()
    want_ret = got["rewards"][got["done"]].sum()
    assert ret == want_ret
    for h in range(5):
        want_h = np.bincount(got["actions"][..., h].reshape(-1),
                             minlength=22)
        assert (hist[h] == want_h).all(), h


def test_stream_exact_matches_exact_chunked():
    """exact=True streams the frozen-finisher trajectories: final state,
    episodes, and dead counts equal rollout_chunked(exact=True), and
    per-env records with dead steps dropped are continuous."""
    _native_or_skip()
    n, T = 8, 200
    s0 = vec.vec_reset(5, n, 4, 1, 0, 30)
    r0 = vec.sampler_init(11, n)
    collected = []
    sS, rS, epsS, cons, deadS = stream.stream_rollout(
        s0, r0, T, chunk=50, block=8, steps_per_push=25,
        consume=lambda r: collected.append(r.copy()), exact=True)
    sC, rC, epsC, deadC = vec.rollout_chunked(
        s0, r0, T, 50, backend="kernel", block=8,
        exact=True)
    assert (epsS, deadS) == (epsC, deadC) and epsS > 0 and deadS > 0
    for name in E.EnvState._fields:
        assert (np.asarray(getattr(sS, name))
                == np.asarray(getattr(sC, name))).all(), name
    rec = np.concatenate(collected)
    got = stream.unpack_records(rec)
    # dead steps repeat the frozen post-episode STATE (done stays set;
    # the action field is the sampler's draw-free deterministic value)
    dead_mask = np.zeros((T, n), bool)
    # done at entry AND still done at exit == dead step (a cleared done
    # right after a chunk boundary is the new episode's first live step)
    dead_mask[1:] = got["done"][:-1] & got["done"][1:]
    prev, cur = rec[:-1], rec[1:]
    state_same = ((cur[..., 1:] == prev[..., 1:]).all(axis=-1)
                  & ((cur[..., 0] >> 25) == (prev[..., 0] >> 25)))
    assert state_same[dead_mask[1:]].all()
    assert dead_mask.sum() == deadS


def test_stream_with_resets_matches_chunked():
    """With episodes ending mid-run, the streaming driver preserves the
    queued-sync auto-reset semantics of rollout_chunked exactly."""
    _native_or_skip()
    n, T = 8, 200
    s0 = vec.vec_reset(5, n, 4, 1, 0, 30)
    r0 = vec.sampler_init(11, n)
    sS, rS, epsS, consumer = stream.stream_rollout(
        s0, r0, T, chunk=50, block=8, steps_per_push=25)
    sC, rC, epsC = vec.rollout_chunked(
        s0, r0, T, 50, backend="kernel", block=8,
        reset_mode="sync")
    assert epsS == epsC > 0
    assert consumer.records == n * T
    for name in E.EnvState._fields:
        assert (np.asarray(getattr(sS, name))
                == np.asarray(getattr(sC, name))).all(), name


def test_compressed_ring_roundtrip():
    """Delta-compressed ring delivery is bit-exact: the decompressed
    record stream equals the raw stream word-for-word, across chunk
    boundaries and mid-run resets, and the header repack covers every
    action/flag field."""
    import numpy as np

    from eldorado_tpu import stream as S
    from eldorado_tpu import vec

    n, chunk, n_chunks = 8, 30, 4
    states = vec.vec_reset(5, n, 4, 1, 0, 10)
    rngs = vec.sampler_init(11, n)
    raw, comp = [], []
    s1, r1, e1, c1 = S.stream_rollout(
        states, rngs, chunk * n_chunks, chunk, block=n,
        steps_per_push=chunk, consume=lambda r: raw.append(r.copy()))
    s2, r2, e2, c2 = S.stream_rollout(
        states, rngs, chunk * n_chunks, chunk, block=n,
        steps_per_push=chunk, consume=lambda r: comp.append(r.copy()),
        compress=True)
    assert e1 == e2 > 0
    assert np.array_equal(np.asarray(r1), np.asarray(r2))
    a = np.concatenate(raw)
    b = np.concatenate(comp)
    assert np.array_equal(a, b)
    assert c1.checksum == c2.checksum
    assert c2.wire_bytes < a.nbytes * 0.7, (c2.wire_bytes, a.nbytes)


def test_compressed_ring_exact_mode():
    """compress=True composes with the frozen-finisher exact mode:
    bit-exact decompressed stream, same dead count as uncompressed."""
    import numpy as np

    from eldorado_tpu import stream as S
    from eldorado_tpu import vec

    states = vec.vec_reset(5, 8, 4, 1, 0, 10)
    rngs = vec.sampler_init(11, 8)
    raw, comp = [], []
    *_, c1, dead1 = S.stream_rollout(
        states, rngs, 90, 30, block=8, steps_per_push=30,
        exact=True, consume=lambda r: raw.append(r.copy()))
    *_, c2, dead2 = S.stream_rollout(
        states, rngs, 90, 30, block=8, steps_per_push=30,
        exact=True, compress=True, consume=lambda r: comp.append(r.copy()))
    assert dead1 == dead2 > 0
    assert np.array_equal(np.concatenate(raw), np.concatenate(comp))
    assert c1.checksum == c2.checksum


def test_device_delivery_refuses_compress():
    """Nothing crosses the device->host link on deliver="device", so a
    compress request is an error, not a silent no-op."""
    import pytest
    from eldorado_tpu import stream as S
    from eldorado_tpu import vec
    states = vec.vec_reset(5, 8, 4, 1, 0, 30)
    rngs = vec.sampler_init(11, 8)
    with pytest.raises(ValueError, match="ring delivery"):
        S.stream_rollout(states, rngs, 20, 10, block=8, deliver="device",
                         compress=True)
