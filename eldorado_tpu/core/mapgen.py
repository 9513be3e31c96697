"""In-jit procedural map generation (single env; vmap for batches).

A fixed-shape, `lax.while_loop` reformulation of the reference's recursive
generator (reference: src/map.cpp:697-742 with the oracle's erase-by-position
patch), bit-exact against eldorado_tpu.core.ref_engine.RefMap.generate:

* The recursion (depth <= MAX_FAILURES = 5) becomes an explicit frame stack.
  Each frame owns a *copy* of the caller's engine state (C++ passes the engine
  by value), a loop counter, and the ordered set of still-eligible travel
  pieces as a bitmask (erase-by-position == clear-bit, since the vector is
  always sorted ascending).
* A mid-loop placement failure pushes a child frame that regenerates a whole
  map **on top of the current one** (the reference does not reset in that
  path); when the child returns, the parent's loop continues with the
  parent's engine state. An end-piece failure clears the map, then retries.
* Pushing past depth 5 aborts the whole generation (C++ throws
  generate_map_failure through every frame): ``ok`` comes back False.
* Rasterisation order matters: later-placed hexes overwrite earlier ones at
  truncation-colliding cells (half-integer rows). Implemented as a
  scatter-max over (slot << 7 | packed-features), which is order-independent
  and therefore safe under XLA's unordered scatter.
* Intermediate ``finalize`` calls are skipped: only the final rasterisation
  is observable (finalize has no effect on generation state).

Geometry is doubled-integer axial (see core/tables.py); all work is int32.
Overlap testing is the reference's exact point-set semantics via a static
pairwise (size, rot, size, rot, center-delta) bit table — no occupancy
raster, no grid bounds, no empirical coordinate margins. The only fixed
capacity is the MAX_PLACED piece-slot budget (see its comment below; the
hex-slot budget follows from it). Overflow sets ``ok`` False rather than
corrupting state.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GRIDSIZE, MAX_N_PLAYERS
from ..ops import rng as R
from . import cells as CE
from . import tables as T

# capacities (static)
MAX_DEPTH = 5            # == MAX_FAILURES
# Placed-piece slot budget. The reference has no cap (its vectors grow,
# src/map.cpp:309-341); a successful generation can legitimately stack
# multiple partial maps (a mid-loop retry regenerates ON TOP of the
# current map without clearing, src/map.cpp:716-731), so the budget must
# cover (2 + n_pieces) x (1 + retries-that-succeeded). 48 covers the
# full n_pieces=16 library through a depth-2 stack and n_pieces <= 14
# through depth-3; beyond that overflow raises MapCapacityError rather
# than corrupting state (tests/test_map_capacity.py sweeps the grid).
MAX_PLACED = 48
HEX_SLOTS = MAX_PLACED * 37
# unconditional-trip prefix of generate_map's hybrid loop harness: the
# failure-free trip count for the default n_pieces=3 (see generate_map)
TRIP_HINT = 7

# pc codes
_ENTRY, _LOOP, _END, _POP = 0, 1, 2, 3
# resume codes
_RES_LOOP_INC, _RES_POP = 0, 1

_i32 = jnp.int32
_u8 = jnp.uint8

# -- static tables as jnp constants ----------------------------------------
_ROT = jnp.asarray(T.ROT, _i32)                        # (6,2,2)
_PIECE_XY = jnp.asarray(T.PIECE_XY, _i32)              # (20,37,2)
_PIECE_VALID = jnp.asarray(T.PIECE_HEX_VALID)          # (20,37)
# per-axis planes + feature-packed table for the finalize-time hex
# reconstruction (split components keep every batched gather/eltwise op
# rank <= 3)
_PIECE_X = jnp.asarray(T.PIECE_XY[:, :, 0], _i32)      # (20,37)
_PIECE_Y = jnp.asarray(T.PIECE_XY[:, :, 1], _i32)      # (20,37)
_PIECE_PACKED = jnp.asarray(                           # (20,37) req|nr<<3|end<<6
    T.PIECE_HEX[:, :, 0] | (T.PIECE_HEX[:, :, 1] << 3)
    | (T.PIECE_HEX[:, :, 2] << 6), _i32)
_ROT00 = jnp.asarray(T.ROT[:, 0, 0], _i32)             # (6,) row-major
_ROT01 = jnp.asarray(T.ROT[:, 0, 1], _i32)
_ROT10 = jnp.asarray(T.ROT[:, 1, 0], _i32)
_ROT11 = jnp.asarray(T.ROT[:, 1, 1], _i32)
_PIECE_SIZE = jnp.asarray(T.PIECE_SIZE, _i32)
_PIECE_TYPE = jnp.asarray(T.PIECE_TYPE, _i32)
_PIECE_HEX = jnp.asarray(T.PIECE_HEX, _i32)            # (20,37,4)
_CONN_N = jnp.asarray(T.CONN_N, _i32)
_CONN_COORD = jnp.asarray(T.CONN_COORD, _i32)          # (3,3,3,21,2)
_CONN_NROT = jnp.asarray(T.CONN_NROT, _i32)
_CONN_ROT = jnp.asarray(T.CONN_ROT, _i32)              # (3,3,3,21,6)

# eligible travel pieces per difficulty, as bitmasks over indices 0..15
_DIFF_MASK = jnp.asarray(
    [sum(1 << i for i in range(T.N_TRAVEL_PIECES)
         if T.PIECE_DIFFICULTY[T.TRAVEL_PIECE_0 + i] <= d)
     for d in range(3)], _i32)


# ---- pairwise piece-overlap bit table --------------------------------------
# Piece coordinates come from exactly 3 size templates (core/tables.py), so
# "candidate footprint intersects placed piece" is a pure function of
# (new_size, cand_rot, placed_size, placed_rot, center_delta). Precomputing
# it as a bit table makes the overlap test ONE word gather + shift per
# (candidate, placed-piece) pair — the reference's sorted-point merge
# (src/map.cpp:53-74) and round 1's 192x192 occupancy-grid raster both
# dissolve. This is also *exactly* the reference's point-set semantics:
# no grid, no clipping, no empirical capacity margins.
_OVL_DMAX = 12           # max |center delta| with any overlap (asserted)
_OVL_ND = 2 * _OVL_DMAX + 1
# static placed-slot window for the VECTORISED pair test: covers every
# fresh (non-retry-stacked) generation — 2 + n_pieces placements for the
# standard configs; the rare stacked case falls back to the pair loop
_OVL_W = 6


def _build_pair_overlap():
    tmpl = [np.asarray(T.LARGE_XY), np.asarray(T.SMALL_XY),
            np.asarray(T.END_XY)]
    tbl = np.zeros((3, 6, 3, 6, _OVL_ND), np.int32)
    dmax = 0
    for sa in range(3):              # candidate (new piece) size
        for ra in range(6):          # candidate rotation
            fa = T.rotate_xy(tmpl[sa], ra)
            for sb in range(3):      # placed piece size
                for rb in range(6):  # placed piece rotation
                    fb = T.rotate_xy(tmpl[sb], rb)
                    # cand cell ca+a == placed cell cb+b  <=>  d := ca-cb
                    # == b-a
                    d = (fb[:, None, :] - fa[None, :, :]).reshape(-1, 2)
                    dmax = max(dmax, int(np.abs(d).max()))
                    w = tbl[sa, ra, sb, rb]
                    np.bitwise_or.at(w, d[:, 0] + _OVL_DMAX,
                                     np.int32(1) << (d[:, 1] + _OVL_DMAX))
    assert dmax <= _OVL_DMAX, dmax
    return tbl.reshape(-1)


_OVL_TBL = jnp.asarray(_build_pair_overlap())


def _select(pred, a, b):
    """tree_map where(pred, a, b) with scalar pred broadcast to leaf rank."""
    def pick(x, y):
        p = pred if x.ndim == 0 else jnp.reshape(pred, (1,) * x.ndim)
        return jnp.where(p, x, y)
    return jax.tree_util.tree_map(pick, a, b)


def _merge(base, *branches):
    """Flat N-way branch merge over ``(pred, tree)`` pairs with mutually
    exclusive predicates: a leaf untouched by a branch (same tracer as
    ``base``) costs nothing; a leaf touched by k branches costs k selects
    (see engine._merge)."""
    leaves_b, treedef = jax.tree_util.tree_flatten(base)
    leaves_v = [jax.tree_util.tree_flatten(v)[0] for _, v in branches]
    out = []
    for i, lb in enumerate(leaves_b):
        val = lb
        for (pred, _), lv in zip(branches, (l[i] for l in leaves_v)):
            if lv is lb:
                continue
            p = pred if lv.ndim == 0 else jnp.reshape(pred,
                                                      (1,) * lv.ndim)
            val = jnp.where(p, lv, val)
        out.append(val)
    return treedef.unflatten(out)


def _rotv(v, times):
    """Rotate doubled coords by times*60 deg. v: (..., 2); times broadcasts
    against v's batch dims."""
    return jnp.einsum("...j,...ij->...i", v, _ROT[times % 6])


class MapGenState(NamedTuple):
    # shared map build state
    entries: jnp.ndarray       # (MAX_PLACED,) i32 piece ids, -1 empty
    entry_rot: jnp.ndarray     # (MAX_PLACED,) i32 rotation AT PLACEMENT —
    #                            per-slot (unlike piece_rot, which is
    #                            pid-keyed and overwritten when a retry
    #                            frame re-places the same pid; the overlap
    #                            test must see each placement's own frame)
    entry_center: jnp.ndarray  # (MAX_PLACED, 2) i32 center at placement
    n_entries: jnp.ndarray     # i32
    # NO per-hex arrays: a placement's 37 hexes are a pure function of
    # (pid, rot, center), so _finalize reconstructs them from the entry
    # slots, instead of carrying (HEX_SLOTS, ·) arrays through the trip
    # loop (vmapped dynamic_update_slice writes + per-iteration
    # loop-carry traffic).
    min_xy: jnp.ndarray        # (2,) i32
    max_xy: jnp.ndarray        # (2,) i32
    piece_rot: jnp.ndarray     # (20,) i32
    piece_center: jnp.ndarray  # (20,2) i32
    # control
    frame_rng: jnp.ndarray     # (MAX_DEPTH,) i32 minstd state
    frame_i: jnp.ndarray       # (MAX_DEPTH,) i32
    frame_valid: jnp.ndarray   # (MAX_DEPTH,) i32 bitmask
    frame_resume: jnp.ndarray  # (MAX_DEPTH,) i32
    sp: jnp.ndarray            # i32
    pc: jnp.ndarray            # i32
    finished: jnp.ndarray      # bool
    aborted: jnp.ndarray       # bool
    overflow: jnp.ndarray      # bool


class MapGenOut(NamedTuple):
    ids: jnp.ndarray          # (2304,) i32 cell-type-id plane (core/cells.py;
    #                           cells.expand_obs -> reference (48,48,7) u8)
    min_xy: jnp.ndarray       # (2,) i32 doubled
    player_start_xy: jnp.ndarray  # (MAX_N_PLAYERS, 2) i32 doubled
    player_start_no: jnp.ndarray  # (MAX_N_PLAYERS,) i32 hex start numbers
    ok: jnp.ndarray           # bool
    overflow: jnp.ndarray     # bool: fixed-capacity bust (MAX_PLACED),
    #                           an engine limitation — distinct from the
    #                           reference's legit generate_map_failure
    n_entries: jnp.ndarray    # i32 (diagnostics)


def _uid(state: MapGenState, n):
    """uniform_int(0, n-1) on the current frame's engine."""
    v, x = R.uniform_int(state.frame_rng[state.sp], n)
    return v.astype(_i32), state._replace(
        frame_rng=state.frame_rng.at[state.sp].set(x))


def _uid_maybe(state: MapGenState, n, do):
    v, x = R.uniform_int_maybe(state.frame_rng[state.sp], n, do)
    return v.astype(_i32), state._replace(
        frame_rng=state.frame_rng.at[state.sp].set(x))


def _add_piece(s: MapGenState, pid, coord, rot) -> MapGenState:
    """reference: src/map.cpp:309-341 (bounds include the previous bounds).
    No occupancy raster: overlap rides the pairwise bit table, so the only
    capacity is the MAX_PLACED slot count."""
    rot6 = rot % 6
    base = _PIECE_XY[pid]                      # (37,2)
    valid = _PIECE_VALID[pid]                  # (37,)
    pxy = _rotv(base, rot6) + coord
    overflow = s.overflow | (s.n_entries >= MAX_PLACED)

    slot = jnp.minimum(s.n_entries, MAX_PLACED - 1)
    entries = s.entries.at[slot].set(pid)
    entry_rot = s.entry_rot.at[slot].set(rot6)
    entry_center = s.entry_center.at[slot].set(coord)

    big = jnp.int32(1 << 20)
    vmin = jnp.min(jnp.where(valid[:, None], pxy, big), axis=0)
    vmax = jnp.max(jnp.where(valid[:, None], pxy, -big), axis=0)
    return s._replace(
        entries=entries, entry_rot=entry_rot, entry_center=entry_center,
        n_entries=s.n_entries + 1,
        min_xy=jnp.minimum(s.min_xy, vmin), max_xy=jnp.maximum(s.max_xy, vmax),
        piece_rot=s.piece_rot.at[pid].set(rot6),
        piece_center=s.piece_center.at[pid].set(coord),
        overflow=overflow)


def _try_add_random(s: MapGenState, pid, active):
    """reference: src/map.cpp:277-307. Returns (state, success). Candidate
    enumeration order is placed-piece-major then connection-entry, matching
    the reference; the overlap test uses each candidate's first rotation
    option only. ``active`` gates the internal rng draws (a caller whose
    branch is not taken this trip must consume nothing — the vmapped
    state machine evaluates every branch and keeps one)."""
    nsize = _PIECE_SIZE[pid]
    epid = jnp.where(s.entries >= 0, s.entries, 0)
    psize = _PIECE_SIZE[epid]                  # (P,)
    ptype = _PIECE_TYPE[epid]
    prot = s.piece_rot[epid]
    pcen = s.piece_center[epid]                # (P,2)
    nconn = _CONN_N[psize, ptype, nsize]       # (P,)
    k_idx = jnp.arange(21)[None, :]
    live = ((jnp.arange(MAX_PLACED) < s.n_entries)[:, None]
            & (k_idx < nconn[:, None]))        # (P,21)

    # Overlap test against every placed piece via the static pairwise bit
    # table: ONE gathered word + shift per (candidate, placed) pair — the
    # candidate footprint is never materialised. The candidate probes its
    # FIRST rotation option only, exactly like the reference's single
    # `overlap()` call per connection entry (src/map.cpp:287-295).
    #
    # The per-candidate tables are materialised ONLY for the rows a trip
    # actually reads: the [:W] window (or the fallback loop's row e), and
    # ONE picked row afterwards. Building the full (48, 21, 6) rotated
    # candidate tables every trip cost ~12k gathered+summed elements per
    # lane per trip (the dominant per-lane term after the overlap gather).
    def cand_coords(rows_pid_idx):
        """Rotated+translated connection coords for entry rows ``rows``
        ((R,) slot indices): -> (R, 21, 2)."""
        e = rows_pid_idx
        c = _CONN_COORD[psize[e], ptype[e], nsize]      # (R,21,2)
        return _rotv(c, prot[e][:, None]) + pcen[e][:, None, :]

    def cand_crot0(rows):
        """First-option candidate rotations for entry rows: (R, 21)."""
        e = rows
        return (_CONN_ROT[psize[e], ptype[e], nsize, :, 0]
                + prot[e][:, None]) % 6

    roww = jnp.arange(_OVL_W)
    coords_w = cand_coords(roww)                        # (W,21,2)
    cbase_w = (nsize * 6 + cand_crot0(roww)) * 3        # (W,21)

    # Pair test, two regimes (identical results, golden-verified):
    #
    # * n_entries <= _OVL_W (every non-retry map — a fresh generation
    #   places 2 + n_pieces <= 6 pieces for the standard configs): ONE
    #   vectorised (W*21, W) gather + rank-3 elementwise test. The
    #   dynamic nested pair fori this replaces dispatched ~8 tiny ops
    #   per (e, f) iteration — sum over a 7-trip generation of n_e^2
    #   iterations ~ 40+ sequential iterations.
    # * n_entries > _OVL_W (retry stacking piled maps past the window —
    #   rare): the live-bounded nested pair loop, whose bounds are ZERO
    #   for every lane in the vector regime (a vmapped fori over a
    #   traced bound runs max-lane iterations, so the common case pays
    #   only its cond).
    #
    # Coordinates stay split per axis: stacking (x, y) would make every
    # elementwise op rank-4.
    cw = coords_w.reshape(_OVL_W * 21, 2)            # (W*21, 2)
    cbw = cbase_w.reshape(_OVL_W * 21)               # (W*21,)

    # candidate-vectorised, placed-LIVE-bounded: one (W*21,) gather per
    # LIVE placed piece (gather volume n_e x 126 instead of the fixed
    # 6 x 126 of a fully-vectorised window — the overlap gather is the
    # per-lane cost driver of generate_map; trips run in
    # lockstep across the queue so the vmapped fori's max-lane bound is
    # the common n_e)
    def one_f(f, hit):
        dx = cw[:, 0] - s.entry_center[f, 0]         # (W*21,)
        dy = cw[:, 1] - s.entry_center[f, 1]
        inr = (jnp.abs(dx) <= _OVL_DMAX) & (jnp.abs(dy) <= _OVL_DMAX)
        idx = ((cbw + psize[f]) * 6 + s.entry_rot[f]) * _OVL_ND \
            + jnp.clip(dx + _OVL_DMAX, 0, _OVL_ND - 1)
        w = _OVL_TBL[idx]                            # (W*21,) gather
        return hit | (inr
                      & (((w >> jnp.clip(dy + _OVL_DMAX, 0, 31)) & 1) > 0))

    hitw = jax.lax.fori_loop(0, jnp.minimum(s.n_entries, _OVL_W), one_f,
                             jnp.zeros((_OVL_W * 21,), bool))
    overlap_vec = jnp.zeros((MAX_PLACED, 21), bool).at[:_OVL_W].set(
        hitw.reshape(_OVL_W, 21))

    use_loop = s.n_entries > _OVL_W

    def row_overlap(e, over):
        ce = cand_coords(e[None])[0]            # (21, 2), on the fly
        cb = (nsize * 6 + cand_crot0(e[None])[0]) * 3   # (21,)

        def one_placed(f, hit):
            d = ce - s.entry_center[f]          # (21, 2)
            dx, dy = d[..., 0], d[..., 1]
            inr = (jnp.abs(dx) <= _OVL_DMAX) & (jnp.abs(dy) <= _OVL_DMAX)
            idx = ((cb + psize[f]) * 6 + s.entry_rot[f]) * _OVL_ND \
                + jnp.clip(dx + _OVL_DMAX, 0, _OVL_ND - 1)
            w = _OVL_TBL[idx]
            return hit | (inr
                          & (((w >> jnp.clip(dy + _OVL_DMAX, 0, 31)) & 1)
                             > 0))

        row = jax.lax.fori_loop(0, s.n_entries, one_placed,
                                jnp.zeros((21,), bool))
        return over.at[e].set(row)

    overlap_loop = jax.lax.fori_loop(
        0, jnp.where(use_loop, s.n_entries, 0), row_overlap,
        jnp.zeros((MAX_PLACED, 21), bool))
    overlap = jnp.where(jnp.reshape(use_loop, (1, 1)), overlap_loop,
                        overlap_vec)
    ok = live & ~overlap

    flat_ok = ok.reshape(-1)
    n_valid = jnp.sum(flat_ok, dtype=_i32)
    have = (n_valid > 0) & active
    pos, s = _uid_maybe(s, n_valid, have)
    csum = jnp.cumsum(flat_ok) - flat_ok       # exclusive prefix counts
    pick = jnp.argmax(flat_ok & (csum == pos)).astype(_i32)
    pe, pk = pick // 21, pick % 21
    # only the PICKED row's coord/rotation data is ever consumed — gather
    # it directly instead of materialising (48, 21, ...) tables
    coord = cand_coords(pe[None])[0, pk]
    nrots_pk = _CONN_NROT[psize[pe], ptype[pe], nsize, pk]
    r, s = _uid_maybe(s, nrots_pk, have)
    rot = _CONN_ROT[psize[pe], ptype[pe], nsize, pk, r] + prot[pe]
    placed = _add_piece(s, pid, coord, rot)
    return _select(have, placed, s), have


def _map_clear(s: MapGenState) -> MapGenState:
    """Map::reset (src/map.cpp:744-752); piece transforms survive."""
    return s._replace(
        entries=jnp.full_like(s.entries, -1),
        n_entries=jnp.zeros_like(s.n_entries),
        min_xy=jnp.zeros_like(s.min_xy),
        max_xy=jnp.zeros_like(s.max_xy))


def _push_child(s: MapGenState, resume) -> MapGenState:
    """generate(..., failures+1, <engine copy>); depth overflow == the
    reference's throw (it fires at child entry, before any draw)."""
    abort = s.sp >= MAX_DEPTH - 1
    sp1 = jnp.minimum(s.sp + 1, MAX_DEPTH - 1)
    return s._replace(
        frame_resume=s.frame_resume.at[s.sp].set(resume),
        frame_rng=jnp.where(abort, s.frame_rng,
                            s.frame_rng.at[sp1].set(s.frame_rng[s.sp])),
        sp=jnp.where(abort, s.sp, sp1),
        pc=jnp.where(abort, s.pc, _ENTRY),
        aborted=s.aborted | abort)


def generate_map(rng_state, n_pieces, difficulty) -> MapGenOut:
    """Run the full generator from engine state ``rng_state`` (uint32).

    The engine is consumed by-value (reference: src/environment.cpp:48):
    callers keep their own stream. ``ok`` is False when the reference would
    have thrown generate_map_failure (or on capacity overflow, which the
    parity suite proves never fires on oracle workloads).
    """
    s = MapGenState(
        entries=jnp.full((MAX_PLACED,), -1, _i32),
        entry_rot=jnp.zeros((MAX_PLACED,), _i32),
        entry_center=jnp.zeros((MAX_PLACED, 2), _i32),
        n_entries=jnp.int32(0),
        min_xy=jnp.zeros((2,), _i32), max_xy=jnp.zeros((2,), _i32),
        piece_rot=jnp.zeros((20,), _i32),
        piece_center=jnp.zeros((20, 2), _i32),
        frame_rng=jnp.full((MAX_DEPTH,), jnp.asarray(rng_state, jnp.int32)),
        frame_i=jnp.zeros((MAX_DEPTH,), _i32),
        frame_valid=jnp.zeros((MAX_DEPTH,), _i32),
        frame_resume=jnp.zeros((MAX_DEPTH,), _i32),
        sp=jnp.int32(0), pc=jnp.int32(_ENTRY),
        finished=jnp.bool_(False), aborted=jnp.bool_(False),
        overflow=jnp.bool_(False))

    n_pieces = jnp.asarray(n_pieces, _i32)
    difficulty = jnp.asarray(difficulty, _i32)

    def body(s: MapGenState) -> MapGenState:
        return _trip(s, n_pieces, difficulty)

    def cond(s: MapGenState):
        return ~(s.finished | s.aborted)

    # Hybrid harness: a failure-free generation takes exactly
    # n_pieces + 4 trips (entry, n_pieces picks, the at-end transition,
    # the end piece, pop), so the first TRIP_HINT trips run as an
    # UNCONDITIONAL fori — under vmap, a while_loop masks every state
    # leaf (incl. the (HEX_SLOTS, 2) hex arrays) per iteration per lane;
    # the fori needs no masking because _trip no-ops on finished/aborted
    # lanes (the ``alive`` gate above). The while then covers retries.
    s = jax.lax.fori_loop(0, TRIP_HINT, lambda i, t: body(t), s)
    s = jax.lax.while_loop(cond, body, s)
    return _finalize(s)


def _trip(s: MapGenState, n_pieces, difficulty) -> MapGenState:
    """One FLAT trip of the reference's recursive generator. A vmapped
    lax.switch evaluates every branch and selects, so the original
    4-branch form paid TWO _try_add_random candidate scans (travel
    piece + end piece) per trip; here the branches share ONE gated
    attempt — the rng draws are gated per branch (_uid_maybe with
    mutually-exclusive conditions), so each branch's stream
    consumption is bit-identical to the switch form."""
    if True:
        # ``alive`` gates every branch and draw: a _trip on a finished
        # or aborted lane is a strict no-op, so the driver may run
        # UNCONDITIONAL trips (generate_map's fori prefix) without
        # perturbing state or stream
        alive = ~(s.finished | s.aborted)
        is_entry = alive & (s.pc == _ENTRY)
        is_loop = alive & (s.pc == _LOOP)
        is_end = alive & (s.pc == _END)
        is_pop = alive & (s.pc == _POP)

        i = s.frame_i[s.sp]
        at_end = i >= n_pieces
        loop_act = is_loop & ~at_end

        # --- gated draws, in each branch's stream order ----------------
        start, s = _uid_maybe(s, 2, is_entry)             # on_entry
        valid = s.frame_valid[s.sp]
        bits = (valid >> jnp.arange(16)) & 1              # (16,)
        nv = jnp.sum(bits, dtype=_i32)
        have_piece = nv > 0
        pos, s = _uid_maybe(s, nv, loop_act & have_piece)  # on_loop pick
        csum = jnp.cumsum(bits) - bits
        idx = jnp.argmax((bits == 1) & (csum == pos)).astype(_i32)
        e, s = _uid_maybe(s, 2, is_end)                   # on_end pick

        # --- on_entry: place the start piece ---------------------------
        entered = _add_piece(s, T.START_PIECE_0 + start, jnp.zeros(2, _i32),
                             jnp.int32(0))
        entered = entered._replace(
            frame_valid=entered.frame_valid.at[entered.sp].set(
                _DIFF_MASK[difficulty]),
            frame_i=entered.frame_i.at[entered.sp].set(0),
            pc=jnp.int32(_LOOP))

        # --- the shared placement attempt (travel OR end piece) --------
        pid = jnp.where(is_end, T.END_PIECE_0 + e, T.TRAVEL_PIECE_0 + idx)
        attempt_act = (loop_act & have_piece) | is_end
        s2, success = _try_add_random(s, pid, attempt_act)

        # on_loop outcomes (src/map.cpp:714-731)
        loop_ok = s2._replace(
            frame_valid=s2.frame_valid.at[s2.sp].set(
                valid & ~(jnp.int32(1) << idx)),
            frame_i=s2.frame_i.at[s2.sp].set(i + 1))
        loop_fail = _push_child(s2, jnp.int32(_RES_LOOP_INC))
        # on_end outcomes (src/map.cpp:733-742)
        end_ok = s2._replace(pc=jnp.int32(_POP))
        end_fail = _push_child(_map_clear(s2), jnp.int32(_RES_POP))

        # on_pop (frame return / finish)
        at_root = s.sp == 0
        sp1 = jnp.maximum(s.sp - 1, 0)
        resume = s.frame_resume[sp1]
        popped = s._replace(
            sp=sp1,
            frame_i=jnp.where(resume == _RES_LOOP_INC,
                              s.frame_i.at[sp1].add(1), s.frame_i),
            pc=jnp.where(resume == _RES_LOOP_INC, jnp.int32(_LOOP),
                         jnp.int32(_POP)))

        return _merge(
            s,
            (is_entry, entered),
            (loop_act & success, loop_ok),
            (loop_act & ~success, loop_fail),
            (is_loop & at_end, s._replace(pc=jnp.int32(_END))),
            (is_end & success, end_ok),
            (is_end & ~success, end_fail),
            (is_pop & at_root, s._replace(finished=jnp.bool_(True))),
            (is_pop & ~at_root, popped))


def _finalize(s: MapGenState) -> MapGenOut:
    # final rasterisation (src/map.cpp:389-405): scatter-max over
    # (slot << 7 | features) gives last-writer-wins per cell. The hexes
    # are RECONSTRUCTED here from the entry slots — each placement's 37
    # hexes are rot(piece template) + center, so the trip loop never
    # carries per-hex arrays (see MapGenState). All gathers/eltwise stay
    # rank <= 2 per lane (<= 3 under vmap) via per-axis planes.
    epid = jnp.where(s.entries >= 0, s.entries, 0)     # (P,)
    bx = _PIECE_X[epid]                                # (P,37)
    by = _PIECE_Y[epid]
    valid = _PIECE_VALID[epid]                         # (P,37)
    packed = _PIECE_PACKED[epid]                       # (P,37)
    r = s.entry_rot % 6                                # (P,)
    px = (_ROT00[r][:, None] * bx + _ROT01[r][:, None] * by
          + s.entry_center[:, 0:1])
    py = (_ROT10[r][:, None] * bx + _ROT11[r][:, None] * by
          + s.entry_center[:, 1:2])
    live = valid & (jnp.arange(MAX_PLACED)[:, None] < s.n_entries)
    ix = ((px - s.min_xy[0]) >> 1) + 1
    iy = ((py - s.min_xy[1]) >> 1) + 1
    in_grid = (ix >= 0) & (ix < GRIDSIZE) & (iy >= 0) & (iy < GRIDSIZE)
    keep = (live & in_grid).reshape(-1)
    lin = jnp.where(keep, (ix * GRIDSIZE + iy).reshape(-1),
                    GRIDSIZE * GRIDSIZE)
    slot = jnp.arange(MAX_PLACED * 37)                 # e*37 + i placement order
    val = jnp.where(keep, (slot << 7) | packed.reshape(-1), -1)
    canvas = jnp.full((GRIDSIZE * GRIDSIZE + 1,), -1, _i32)
    canvas = canvas.at[lin].max(val)[: GRIDSIZE * GRIDSIZE]
    req = canvas & 7
    n_req = (canvas >> 3) & 7
    is_end = (canvas >> 6) & 1
    filled = canvas >= 0
    # The canonical output is the flat 5-bit cell-type-id plane
    # (core/cells.py): a pure compare-select encode of the per-cell
    # (req, n_req, is_end) triple — no channel raster, no scatter, no
    # narrow-minor layout. The reference-ABI (48, 48, 7) u8 expansion
    # (src/map.cpp:389-405's raster shape) happens only at cold API
    # boundaries via cells.expand_obs.
    ids = jnp.where(filled, CE.cell_type_ids(req, n_req, is_end), 0)

    # add_players inputs: the first four hex slots are the start piece's
    # numbered start hexes (src/map.cpp:343-354); the caller applies the
    # (0 < start < n_players+1) & (i < n_players) gate.
    pid0 = jnp.where(s.entries[0] >= 0, s.entries[0], 0)
    starts = _PIECE_HEX[pid0, :MAX_N_PLAYERS, 3]
    start_xy = jnp.stack([px[0, :MAX_N_PLAYERS], py[0, :MAX_N_PLAYERS]],
                         axis=-1)
    return MapGenOut(ids=ids, min_xy=s.min_xy,
                     player_start_xy=start_xy,
                     player_start_no=starts,
                     ok=~(s.aborted | s.overflow),
                     # aborted wins: the reference's mid-loop retry stacks a
                     # fresh map onto the old one without clearing
                     # (src/map.cpp:716-731), so doomed retries legitimately
                     # hit MAX_PLACED on the way to the throw — only an
                     # overflow in a *finished* generation is a capacity bust
                     overflow=s.overflow & ~s.aborted,
                     n_entries=s.n_entries)
