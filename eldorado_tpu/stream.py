"""Per-step learner feed: packed trajectory records off the blocked scan.

The reference's entire product is observation views the algorithm reads
*every step*: zero-copy ``observations`` / ``selected_action_masks``
numpy properties refreshed in place and consumed per iteration
(reference: include/pybind/vectorized.h:60-150, pytest/test_vec_env.py:
97-112). Here the equivalent cannot be a host pointer — the state lives
in device memory — so the high-throughput path emits, from inside the
blocked rollout scan, one packed 5-word record per env per step
carrying everything a policy conditions on / trains off:

    word0  action (5 sub-actions x 5 bits) | done<<25 | agent<<26
           | phase<<28
    word1  rewards (4 players x 4-bit two's complement; zero-sum values
           lie in [-4, 4]) | machete<<16 (3b) | paddle<<19 (3b)
           | round(2*coins)<<22 (10b, clamped — coins never near 511 in
           real play)
    word2..4  the selected-action mask's 3 packed words
           (engine.pack_mask layout; index 92 bits via engine.unpack_mask)

All fields are POST-step state (the mask/resources/phase presented for
the NEXT action), matching the reference driver's read-after-step
ordering; ``action`` and ``rewards`` belong to the step itself. Records
flow device -> host -> native TrajectoryRing (lock-free SPSC,
native/obs_abi.cpp) -> consumer thread; see ``stream_rollout`` and
``RingConsumer``.
"""
from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

RECORD_WORDS = 5
# The FULL-observation record (record="full"): the 5 compact words plus
# everything else ObsData carries (reference include/api.h:84-129), so a
# consumer can maintain a field-exact mirror of the observation surface
# for every env at every step (see ObsReconstructor):
#
#     word5..31   the ACTING player's post-step (5, 21) pile counts,
#                 one full u8 each (4 counts/word): the reference's u8
#                 count arithmetic makes wrapped values observable state
#                 (255 = -1, and drift continues: -17 seen in real play,
#                 golden-verified), so nothing narrower than the full u8
#                 domain round-trips exactly
#     word32      shop stock slots 0..15, 2 bits each (stock <= 3)
#     word33      shop slots 16, 17 (bits 0..3) | actor<<4 (the acting
#                 player, whose piles/storage-row this record carries)
#                 | shop_overflow<<7
#                 | machete<<8 (5b) | paddle<<13 (5b)
#                 | round(2*coins)<<18 (12b) | res_overflow<<30
#                 (word1's 3-bit resource fields suit a bandit consumer;
#                 these wider fields make current_resources exact — the
#                 turn-local maxima are ~12/12/~20, still flagged honest)
#     word34..36  the actor's post-step STORAGE mask row (3 packed words)
#     word37..39  the post-step agent's storage row (a step writes at
#                 most these two rows: engine._step_from_view's
#                 mask_p_final / mask_r_final single-pass write-back)
#
# The map is not per-step data: it changes only at reset, and reset
# events ship the full reset-queue result buffer (map id planes + every
# dynamic field of the reset envs) as per-event KEYFRAMES
# (stream_rollout(record="full") collects them; parse_reset_buffer /
# ObsReconstructor.apply_reset consume them).
RECORD_WORDS_FULL = 40


def pack_step_blocked(bact, bdone, brew, bagent, bsel, bres, bphase):
    """Blocked per-step leaves -> (nb, 5, block) i32 packed records.

    Inputs are the blocked scan's layouts: bact (nb,5,block) i32,
    bdone/bagent/bphase (nb,1,block) i32, brew (nb,4,block) f32,
    bsel (nb,3,block) i32, bres (nb,3,block) f32.
    """
    i32 = jnp.int32
    w0 = jnp.zeros_like(bdone)
    for i in range(5):
        w0 = w0 | (bact[:, i:i + 1] << (5 * i))
    w0 = (w0 | (bdone << 25) | (bagent << 26) | (bphase << 28))

    rew = jnp.round(brew).astype(i32)              # integers in [-4, 4]
    w1 = jnp.zeros_like(bdone)
    for i in range(4):
        w1 = w1 | ((rew[:, i:i + 1] & 0xF) << (4 * i))
    mach = jnp.clip(jnp.round(bres[:, 0:1]).astype(i32), 0, 7)
    padd = jnp.clip(jnp.round(bres[:, 1:2]).astype(i32), 0, 7)
    coin2 = jnp.clip(jnp.round(bres[:, 2:3] * 2.0).astype(i32), 0, 1023)
    w1 = w1 | (mach << 16) | (padd << 19) | (coin2 << 22)

    return jnp.concatenate([w0, w1, bsel], axis=1)


def pack_step_full_blocked(base5, bpiles, bshop, bstorage, bres, p_pre,
                           bagent):
    """Extend one step's compact records to the FULL observation surface.

    ``base5``: (nb, 5, block) from pack_step_blocked. ``bpiles``
    (nb, 4, 5, 21, block) u8, ``bshop`` (nb, 18, block) u8, ``bstorage``
    (nb, 4, 3, block) i32, ``bres`` (nb, 3, block) f32 are the POST-step
    blocked leaves; ``p_pre`` (nb, 1, block) is the PRE-step agent (the
    actor whose piles/storage row this step wrote), ``bagent`` the
    post-step agent. Returns (nb, 40, block) i32 (layout: module
    docstring / RECORD_WORDS_FULL)."""
    i32 = jnp.int32
    nb, _, _, _, block = bpiles.shape
    pil = bpiles.astype(i32).reshape(nb, 4, 105, block)
    pp = sum(jnp.where(p_pre == j, pil[:, j], 0) for j in range(4))
    # full u8 fields: the reference's wrapped counts are observable and
    # drift without bound, so nothing narrower round-trips exactly
    ppad = jnp.concatenate([pp, jnp.zeros((nb, 3, block), i32)], axis=1)
    pw = jnp.zeros((nb, 27, block), i32)
    for k in range(4):                     # strided: field k of all 27 words
        pw = pw | ((ppad[:, k::4] & 255) << (8 * k))
    sh = bshop.astype(i32)
    w19 = jnp.zeros((nb, 1, block), i32)
    for k in range(16):
        w19 = w19 | ((sh[:, k:k + 1] & 3) << (2 * k))
    over_s = jnp.max(sh, axis=1, keepdims=True) > 3
    mach = jnp.round(bres[:, 0:1]).astype(i32)
    padd = jnp.round(bres[:, 1:2]).astype(i32)
    coin2 = jnp.round(bres[:, 2:3] * 2.0).astype(i32)
    over_r = (mach > 31) | (padd > 31) | (coin2 > 4095)
    w33 = ((sh[:, 16:17] & 3) | ((sh[:, 17:18] & 3) << 2)
           | (p_pre << 4)
           | (over_s.astype(i32) << 7)
           | (jnp.clip(mach, 0, 31) << 8) | (jnp.clip(padd, 0, 31) << 13)
           | (jnp.clip(coin2, 0, 4095) << 18)
           | (over_r.astype(i32) << 30))
    rowp = sum(jnp.where(p_pre == j, bstorage[:, j], 0) for j in range(4))
    rowr = sum(jnp.where(bagent == j, bstorage[:, j], 0) for j in range(4))
    return jnp.concatenate([base5, pw, w19, w33, rowp, rowr], axis=1)


def unpack_full(buf):
    """(..., 40) i32 full records -> planar fields (numpy): the compact
    fields plus actor (...,), actor_piles (..., 5, 21) u8, shop (..., 18)
    u8, storage_row_p / storage_row_r (..., 3) i32, exact resources,
    overflow flags."""
    buf = np.asarray(buf)
    out = unpack_records(buf[..., :5])
    w20 = buf[..., 33]
    counts = np.stack([(buf[..., 5 + j // 4] >> (8 * (j % 4))) & 255
                       for j in range(105)], axis=-1)
    out["actor"] = ((w20 >> 4) & 3).astype(np.uint8)
    out["actor_piles"] = counts.astype(np.uint8).reshape(
        buf.shape[:-1] + (5, 21))
    shop = [(buf[..., 32] >> (2 * k)) & 3 for k in range(16)]
    shop += [w20 & 3, (w20 >> 2) & 3]
    out["shop"] = np.stack(shop, axis=-1).astype(np.uint8)
    out["shop_overflow"] = ((w20 >> 7) & 1).astype(bool)
    # exact current_resources (supersedes word1's 3-bit bandit fields)
    out["resources"] = np.stack(
        [((w20 >> 8) & 31).astype(np.float32),
         ((w20 >> 13) & 31).astype(np.float32),
         ((w20 >> 18) & 0xFFF).astype(np.float32) * 0.5], axis=-1)
    out["res_overflow"] = ((w20 >> 30) & 1).astype(bool)
    out["storage_row_p"] = buf[..., 34:37]
    out["storage_row_r"] = buf[..., 37:40]
    return out


def unpack_records(buf):
    """(..., 5) i32 records -> dict of planar fields (numpy).

    Returns actions (...,5) u8, done bool, agent u8, phase u8,
    rewards (...,4) i8, resources (...,3) f32, sel_words (...,3) i32.
    """
    buf = np.asarray(buf)
    w0 = buf[..., 0]
    w1 = buf[..., 1]
    actions = np.stack([(w0 >> (5 * i)) & 31 for i in range(5)],
                       axis=-1).astype(np.uint8)
    done = ((w0 >> 25) & 1).astype(bool)
    agent = ((w0 >> 26) & 3).astype(np.uint8)
    phase = ((w0 >> 28) & 3).astype(np.uint8)
    rew4 = np.stack([(w1 >> (4 * i)) & 0xF for i in range(4)], axis=-1)
    rewards = (rew4.astype(np.int8) << 4 >> 4)     # sign-extend 4 bits
    resources = np.stack(
        [((w1 >> 16) & 7).astype(np.float32),
         ((w1 >> 19) & 7).astype(np.float32),
         ((w1 >> 22) & 0x3FF).astype(np.float32) * 0.5], axis=-1)
    return {"actions": actions, "done": done, "agent": agent,
            "phase": phase, "rewards": rewards, "resources": resources,
            "sel_words": buf[..., 2:5]}


class RingConsumer(threading.Thread):
    """Consumer thread draining a TrajectoryRing of packed records.

    Pops fixed-size blocks of ``steps_per_push`` steps x n_envs x 5
    words, calls ``fn(records)`` on each (records viewed i32,
    shape (steps_per_push, n, 5)); counts records and keeps a rolling
    xor checksum so the demo path can assert data actually moved.
    """

    def __init__(self, ring, steps_per_push: int, n_envs: int, fn=None,
                 record_words: int = RECORD_WORDS):
        super().__init__(daemon=True)
        self.ring = ring
        self.spp = steps_per_push
        self.n = n_envs
        self.fn = fn
        self.words = record_words
        self.records = 0
        self.checksum = np.int64(0)
        self._stopping = threading.Event()

    def run(self):
        while True:
            buf = self.ring.pop()
            if buf is None:
                if self._stopping.is_set():
                    return
                time.sleep(0.0005)
                continue
            rec = buf.view(np.int32).reshape(self.spp, self.n, self.words)
            self.records += self.spp * self.n
            flat = rec.reshape(-1)
            self.checksum ^= np.bitwise_xor.reduce(
                flat.view(np.int64) if flat.size % 2 == 0
                else flat.astype(np.int64))
            if self.fn is not None:
                self.fn(rec)

    def finish(self):
        self._stopping.set()
        self.join()


def parse_reset_buffer(buf, feat, q_cap, n_envs):
    """Parse one reset-queue RESULT buffer (vec._KernelPrograms._reset_q
    output) into keyframe fields: the per-event channel carrying the new
    MAP ID PLANES and every dynamic field of the envs reset at a chunk
    boundary. Returns dict with idxs/valid/ok/overflow/min_xy/map_ids and
    dyn[name] arrays of shape (q_cap, ...) in engine dtypes; padding
    slots (idx >= n_envs) must be dropped via ``valid``."""
    buf = np.asarray(buf)
    Q = q_cap
    idxs = buf[:Q]
    off = Q
    ok, over = int(buf[off]), int(buf[off + 1])
    off += 2
    min_xy = buf[off:off + 2 * Q].reshape(Q, 2)
    off += 2 * Q
    MAPW = 48 * 48
    map_ids = buf[off:off + Q * MAPW].reshape(Q, MAPW)
    off += Q * MAPW
    dyn = {}
    for name, fshape, fdtype in feat:
        F = max(1, int(np.prod(fshape)))
        seg = buf[off:off + Q * F]
        off += Q * F
        if fdtype == jnp.float32:
            seg = seg.view(np.float32)
        elif fdtype == jnp.bool_:
            seg = seg != 0
        dyn[name] = np.asarray(seg).reshape((Q,) + tuple(fshape)).astype(
            np.dtype(fdtype) if fdtype != jnp.float32 else np.float32)
    assert off == buf.size, (off, buf.size)
    return {"idxs": idxs, "valid": idxs < n_envs, "ok": ok,
            "overflow": over, "min_xy": min_xy, "map_ids": map_ids,
            "dyn": dyn}


class ObsReconstructor:
    """Host-side mirror of the FULL observation surface, driven by the
    record="full" feed: per-step records update the acting player's
    piles, the shop, the two written storage-mask rows, the sel mask and
    the scalars; per-event reset KEYFRAMES (parse_reset_buffer) refresh
    everything — including the map id plane — for the envs reset at a
    chunk boundary. Field-exact against the engine by construction
    (tests/test_stream_full.py steps an XLA replay alongside).

    This is the device-resident analogue of the reference's per-step
    ObsData views (include/pybind/vectorized.h:60-150): the observation state
    lives with the consumer and the wire carries only what changed.
    """

    def __init__(self, states, feat=None, q_cap=None):
        s = jax.device_get(states)
        n = int(np.asarray(s.rng).shape[0])
        self.n = n
        self.feat = feat
        self.q_cap = q_cap
        self.piles = np.array(s.piles, np.uint8)
        self.shop = np.array(s.shop_stock, np.uint8)
        self.storage = np.array(s.storage_masks, np.int32)   # packed rows
        self.sel = np.array(s.sel_mask, np.int32)
        self.map_ids = np.array(s.map_ids, np.int32)
        self.min_xy = np.array(s.min_xy, np.int32)
        self.agent = np.array(s.agent, np.int32)
        self.phase = np.array(s.phase, np.int32)
        self.resources = np.array(s.resources, np.float32)
        self.done = np.array(s.done, bool)
        self._ar = np.arange(n)

    def apply_step(self, rec):
        """One step's (n, 40) env-major full records -> mirror update."""
        d = unpack_full(rec)
        actor = d["actor"].astype(np.int64)
        ragent = d["agent"].astype(np.int64)
        self.piles[self._ar, actor] = d["actor_piles"]
        self.shop[:] = d["shop"]
        self.storage[self._ar, actor] = d["storage_row_p"]
        self.storage[self._ar, ragent] = d["storage_row_r"]
        self.sel[:] = rec[..., 2:5]
        self.agent[:] = ragent
        self.phase[:] = d["phase"]
        self.resources[:] = d["resources"]
        self.done[:] = d["done"]

    def apply_reset(self, buf):
        """One reset keyframe (raw result buffer or parse_reset_buffer
        dict) -> refresh the reset envs' rows."""
        if not isinstance(buf, dict):
            buf = parse_reset_buffer(buf, self.feat, self.q_cap, self.n)
        v = buf["valid"]
        rows = buf["idxs"][v].astype(np.int64)
        self.map_ids[rows] = buf["map_ids"][v]
        self.min_xy[rows] = buf["min_xy"][v]
        dyn = buf["dyn"]
        self.piles[rows] = dyn["piles"][v]
        self.shop[rows] = dyn["shop_stock"][v]
        self.storage[rows] = dyn["storage_masks"][v]
        self.sel[rows] = dyn["sel_mask"][v]
        self.agent[rows] = dyn["agent"][v]
        self.phase[rows] = dyn["phase"][v]
        self.resources[rows] = dyn["resources"][v]
        self.done[rows] = dyn["done"][v]

    def observations(self):
        """The reference ObsData surface (include/api.h:84-129) for every
        env, reconstructed: map (n,48,48,7) u8, phase, current_resources,
        shop, piles (n,4,5,21), action_masks (n,4,92) from the storage
        rows, selected masks (n,92)."""
        from .core import cells as C
        from .core import engine as E
        return {
            "map": C.expand_obs_np(self.map_ids),
            "phase": self.phase.astype(np.uint8),
            "current_resources": self.resources,
            "shop": self.shop,
            "piles": self.piles,
            "action_masks": np.asarray(E.unpack_mask(self.storage)),
            "selected_action_masks": np.asarray(E.unpack_mask(self.sel)),
        }


def device_stats_init():
    """Carry for the demo on-device consumer: (steps, done_steps,
    return_sum, action_histogram[5][22]). done_steps counts per-step
    done flags (a finished env stays done while dead-stepping to its
    reset boundary, so this exceeds the episode count); return_sum is
    zero by construction on full batches (the game is zero-sum)."""
    return (jnp.int32(0), jnp.int32(0), jnp.float32(0.0),
            jnp.zeros((5, 22), jnp.int32))


def device_stats_fn(carry, traj):
    """Demo ON-DEVICE learner-feed consumer: folds one chunk's blocked
    records (T, nb, 5, block) into running statistics — the pattern a
    JAX learner uses to train off the feed without the data ever leaving
    device memory (the replacement for the reference's host-side
    observation views). Jitted per chunk by ``stream_rollout``."""
    steps, eps, ret, hist = carry
    w0 = traj[:, :, 0]
    w1 = traj[:, :, 1]
    done = (w0 >> 25) & 1
    steps = steps + jnp.int32(traj.shape[0]) * jnp.int32(
        traj.shape[1] * traj.shape[3])
    eps = eps + jnp.sum(done)
    # sign-extended 4-bit rewards, summed over players where done
    for i in range(4):
        r = ((w1 >> (4 * i)) & 0xF).astype(jnp.int32)
        r = jnp.where(r >= 8, r - 16, r)
        ret = ret + jnp.sum(jnp.where(done != 0, r, 0).astype(jnp.float32))
    for h in range(5):
        a = (w0 >> (5 * h)) & 31
        oh = a[..., None] == jnp.arange(22)
        hist = hist.at[h].add(jnp.sum(oh.astype(jnp.int32),
                                      axis=(0, 1, 2)))
    return (steps, eps, ret, hist)


def stream_rollout(states, sampler_rngs, n_steps: int, chunk: int = 1500,
                   mask_src: str = "storage", block: int = 1024,
                   ring=None,
                   steps_per_push: int = 100, consume=None,
                   deliver: str = "ring", device_fn=None,
                   device_carry=None, exact: bool = False,
                   record: str = "compact", compress: bool = False):
    """High-throughput rollout that DELIVERS the per-step feed.

    Same auto-reset semantics as ``rollout_chunked(backend="kernel",
    reset_mode="sync")`` — on-device queued resets at chunk boundaries —
    plus per-chunk delivery of the packed (chunk, n, 5) records:

    * ``deliver="ring"``: the record buffer is fetched to the host and
      pushed into ``ring`` (a native ``TrajectoryRing``; created here
      when None) in blocks of ``steps_per_push`` steps while the device
      runs the NEXT chunk (XLA async dispatch overlaps the fetch with
      compute); a ``RingConsumer`` (wrapping ``consume``) drains it
      concurrently. Returns (states, rngs, episodes, consumer), the
      consumer ``finish()``ed with ``.records``/``.checksum`` filled.
      Delivery rate is bounded by the device->host link.
      ``compress=True`` delta-encodes each chunk on the device before
      the fetch (compact records only; ``.wire_bytes`` counts what
      crossed the link).
    * ``deliver="device"``: no host transfer — ``device_fn(carry,
      traj_blocked)`` (default: ``device_stats_fn``) is jitted and
      folded over each chunk's blocked (chunk, nb, 5, block) records ON
      DEVICE, the way a co-located JAX learner consumes the feed.
      Returns (states, rngs, episodes, device_carry). Nothing crosses
      the link, so ``compress`` is refused.

    ``exact=True`` uses the frozen-finisher mode (engine
    fused_sample_step gate_dead): finished envs consume no sampler
    draws until their reset lands, so per-env record sequences with
    dead steps excluded are bit-exact vs the reference's continuous
    same-step auto-reset streams (a dead step repeats the frozen
    post-episode record with done=1; consumers drop them via the done
    flag). The last tuple element gains the dead-step count.

    ``record="full"`` widens records to the FULL observation surface
    (40 words: actor piles, shop, written storage rows — module
    docstring) and, on the ring path, ships each reset event's result
    buffer as a KEYFRAME: the returned consumer gains ``.keyframes``
    (ordered ``(chunk_index, buffer)``, each parseable by
    parse_reset_buffer with ``.feat``/``.q_cap``), where keyframe k
    applies AFTER chunk k's records. ObsReconstructor consumes both
    channels to mirror ObsData field-exactly for every env/step.
    (A co-located DEVICE consumer needs no map keyframes: the map is
    reset-stable and lives on device — read ``states.map_ids`` between
    chunks, or fold a custom ``device_fn`` over the records for
    everything that changes per step.)
    """
    from . import vec as V
    from .errors import GenerateMapFailure, MapCapacityError
    n = int(states.rng.shape[0])
    want = "packed" if record == "compact" else "full"
    words = RECORD_WORDS if record == "compact" else RECORD_WORDS_FULL
    if compress and (deliver != "ring" or record != "compact"):
        raise ValueError("compress applies to ring delivery of compact "
                         f"records (got deliver={deliver!r}, "
                         f"record={record!r})")
    progs = V._kernel_programs(states, mask_src, block, gate_dead=exact)
    keyframes = []
    if deliver == "ring":
        assert chunk % steps_per_push == 0, (chunk, steps_per_push)
        if ring is None:
            from .native import TrajectoryRing
            cap = max(4, 4 * chunk // steps_per_push)
            ring = TrajectoryRing(steps_per_push * n * words * 4, cap)
        consumer = RingConsumer(ring, steps_per_push, n, consume,
                                record_words=words)
        consumer.start()
    else:
        assert deliver == "device", deliver
        if device_fn is None:
            device_fn = device_stats_fn
            device_carry = device_stats_init()
        device_fn = jax.jit(device_fn, donate_argnums=(0,))

    bctx, bdyn, brngs = progs.block_in(states, sampler_rngs)
    qstate = progs.qstate_init()
    n_chunks = max(1, n_steps // chunk)
    pending = None        # device (chunk, n, words) buffer in flight
    if deliver == "device":
        # fully-fused chunks: scan + cond-gated reset + records, NO host
        # sync in the loop
        for _ in range(n_chunks):
            bctx, bdyn, brngs, qstate, states, traj = progs.run_auto_traj(
                bctx, bdyn, brngs, qstate, states, chunk, want)
            device_carry = device_fn(device_carry, traj)
    else:
        hprev = None
        if compress:
            cprev = jnp.zeros((n, 4), jnp.int32)   # device delta carry
            hprev = np.zeros((n, 4), np.int32)     # host mirror
            consumer.wire_bytes = 0
        for ci in range(n_chunks):
            bdyn, brngs, qstate, any_new, resetq, traj = progs.run_q(
                bctx, bdyn, brngs, qstate, chunk, want)
            if bool(any_new):
                buf = progs.reset_q(resetq)
                if want == "full":
                    # keyframe channel: the reset envs' fresh map id
                    # planes + full dynamic state, applied after this
                    # chunk's records (queued resets land at boundaries)
                    keyframes.append((ci, np.asarray(buf)))
                bdyn, bctx, states, qstate = progs.apply_q(
                    bdyn, bctx, states, qstate, buf)
            if pending is not None:
                hprev = _drain_any(pending, ring, steps_per_push,
                                   consumer, hprev)
            rec = progs.unblock_packed(traj)       # async device transpose
            if compress:
                hdr, payload, used, cprev = compress_chunk(rec, cprev)
                pending = (hdr, payload, used)
            else:
                pending = rec
        if pending is not None:
            hprev = _drain_any(pending, ring, steps_per_push, consumer,
                               hprev)

    counters = np.asarray(qstate[1])
    episodes = int(counters[0])
    states, sampler_rngs = progs.unblock(states, bdyn, brngs)
    if counters[2]:
        raise MapCapacityError("stream: map generation overflowed")
    if counters[1]:
        raise GenerateMapFailure("stream: map generation failed")
    if np.asarray(states.done).any():
        states, k = V.reset_done_bucketed(states)
        episodes += k
    sink = device_carry if deliver == "device" else None
    if deliver == "ring":
        consumer.finish()
        consumer.keyframes = keyframes
        consumer.feat = progs.feat
        consumer.q_cap = progs.q_cap
        sink = consumer
    if exact:
        return states, sampler_rngs, episodes, sink, int(counters[3])
    return states, sampler_rngs, episodes, sink


def _drain(dev_buf, ring, steps_per_push):
    """Fetch one chunk's (chunk, n, 5) device buffer and push it into
    the ring in steps_per_push blocks (spinning briefly when full)."""
    host = np.asarray(dev_buf)
    T = host.shape[0]
    for t0 in range(0, T, steps_per_push):
        blockv = host[t0:t0 + steps_per_push]
        while not ring.push(blockv):
            time.sleep(0.0005)            # consumer is draining


def _drain_any(pending, ring, steps_per_push, consumer, hprev):
    """Drain one chunk — raw (device records array) or compressed
    ((hdr, payload, used) from compress_chunk): compressed chunks fetch
    only header + used-payload prefix through the device link, then
    decompress on the host and push full records into the ring. Returns
    the updated host delta carry (None for raw)."""
    if hprev is None:
        _drain(pending, ring, steps_per_push)
        return None
    hdr_d, pay_d, used_d = pending
    used = int(np.asarray(used_d))
    # bucket the prefix geometrically (ratio 1.25, 256-word aligned) so
    # the slice program compiles ~dozens of shapes while overfetching
    # <= 25%
    total = int(pay_d.shape[0])
    k = 256
    while k < used:
        k = (k * 5 // 4 + 255) & ~255
    k = min(total, k)
    hdr = np.asarray(hdr_d)
    pay = np.asarray(pay_d[:k]) if k else np.zeros(0, np.int32)
    if consumer is not None:
        consumer.wire_bytes += hdr.nbytes + pay.nbytes + 4
    rec, hprev = decompress_chunk(hdr, pay, hprev)
    T = rec.shape[0]
    for t0 in range(0, T, steps_per_push):
        blockv = rec[t0:t0 + steps_per_push]
        while not ring.push(blockv):
            time.sleep(0.0005)
    return hprev


# ------------------------------------------------------------ compression
# The ring path is bound by the device->host link. The records are
# highly redundant step-to-step (measured at 4096-env self-play: word1
# changes 64% of steps, sel word2 20%, words 3-4 ~never), so the device
# can delta-encode each chunk before the fetch:
#
#   header (T, n) i32 — the always-changing fields repacked to exactly
#     32 bits: action (23b: the five heads are 5/5/5/3/5-bit by their
#     legal ranges) | done<<23 | agent<<24 | phase<<26 | chg<<28 (4 bits
#     flagging which of words 1..4 changed vs the previous step)
#   payload — the changed words' NEW values, compacted in flat
#     (t, env, word) order by a device cumsum+scatter; the host fetches
#     only payload[:used] (rounded up to 64K-word buckets so the slice
#     program compiles a handful of shapes, not one per chunk).
#
# Decompression is a vectorised gather (last-change forward fill) and
# bit-exact (tests/test_stream.py::test_compressed_ring_roundtrip).


@jax.jit
def compress_chunk(rec, prev):
    """(T, n, 5) i32 records + (n, 4) previous words 1..4 ->
    (header (T,n), payload (T*n*4,), used scalar, new prev)."""
    i32 = jnp.int32
    w0 = rec[..., 0]
    w = rec[..., 1:5]                                  # (T, n, 4)
    wprev = jnp.concatenate([prev[None], w[:-1]], axis=0)
    chg = w != wprev
    a0 = w0 & 31
    a1 = (w0 >> 5) & 31
    a2 = (w0 >> 10) & 31
    a3 = (w0 >> 15) & 7                                # move head: <= 6
    a4 = (w0 >> 20) & 31
    hdr = (a0 | (a1 << 5) | (a2 << 10) | (a3 << 15) | (a4 << 18)
           | (((w0 >> 25) & 1) << 23)                  # done
           | (((w0 >> 26) & 3) << 24)                  # agent
           | (((w0 >> 28) & 3) << 26))                 # phase
    for k in range(4):
        hdr = hdr | (chg[..., k].astype(i32) << (28 + k))
    flags = chg.reshape(-1)
    total = flags.shape[0]
    pos = jnp.cumsum(flags.astype(i32)) - 1
    used = pos[-1] + 1
    idx = jnp.where(flags, pos, total)
    payload = jnp.zeros((total,), i32).at[idx].set(
        w.reshape(-1), mode="drop")
    return hdr, payload, used, w[-1]


def decompress_chunk(hdr, payload, prev):
    """Inverse of compress_chunk (numpy): -> ((T, n, 5) records,
    new prev). ``payload`` may be any prefix covering the used words."""
    hdr = np.asarray(hdr)
    T, n = hdr.shape
    w0 = ((hdr & 31) | (((hdr >> 5) & 31) << 5) | (((hdr >> 10) & 31) << 10)
          | (((hdr >> 15) & 7) << 15) | (((hdr >> 18) & 31) << 20)
          | (((hdr >> 23) & 1) << 25) | (((hdr >> 24) & 3) << 26)
          | (((hdr >> 26) & 3) << 28))
    chg = np.stack([(hdr >> (28 + k)) & 1 for k in range(4)],
                   axis=-1).astype(bool)               # (T, n, 4)
    flags = chg.reshape(-1)
    cnt = int(flags.sum())
    vals = np.zeros(T * n * 4, np.int32)
    vals[flags] = np.asarray(payload)[:cnt]
    vals = vals.reshape(T, n, 4)
    # forward fill: each slot takes the value at its LAST change <= t
    # (index 0 = carried prev) via one gather
    last = np.maximum.accumulate(
        np.where(chg, np.arange(1, T + 1)[:, None, None], 0), axis=0)
    table = np.concatenate([prev[None], vals], axis=0)  # (T+1, n, 4)
    ni, ki = np.meshgrid(np.arange(n), np.arange(4), indexing="ij")
    w = table[last, ni[None], ki[None]]                # (T, n, 4)
    rec = np.concatenate([w0[..., None], w], axis=-1).astype(np.int32)
    return rec, w[-1].copy()
