"""Jittable single-env engine: pure-functional reset / step / observation.

The device core. One environment's entire state is the `EnvState` pytree
(struct-of-arrays over the batch once vmapped); `reset_env` and `step_env` are
pure functions traced once and compiled by XLA. Dispatch is a chain of masked
state selections (every branch is computed, exactly one is kept) — the
lockstep form of the reference's data-dependent turn logic (reference:
src/environment.cpp:91-224). Bit-exact against
eldorado_tpu.core.ref_engine.RefEnv, which is itself bit-exact against the
UB-patched reference oracle (see tests/golden).

Performance shape: every data-dependent update is expressed as one-hot
arithmetic (`where(iota == idx, ...)`) instead of scatter/gather — the
first draft had 228 scatters per step; the one-hot form fuses into the
surrounding elementwise work. The only gathers left are the 48x48x7 map-cell
lookups. Branch merges go through `_select`, which skips untouched leaves
(they are the same traced value on both sides), so per-step HBM traffic stays
at the few-hundred-bytes-per-env the game state actually changes.

Semantics notes (same quirk set as ref_engine — see its module docstring):
uint8 wraparound everywhere the reference uses u_char; dual mask surfaces
(selected vs per-player storage); by-value RNG into map generation; rewards /
info buffers persisting across resets; `played` pile surviving reset.

RNG bounds per step: at most 5 engine draws from a move (discard/remove
picks, reference src/player.cpp:85-131), or 4 from an end-of-turn redraw, or
3 from a card special — statically unrolled, consuming the stream only on
live iterations via the loop-free two-attempt rejection kernel
(ops/rng.py uniform_int_fast; deviations tracked in ``rng_tainted``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    GRIDSIZE,
    HAND_SIZE,
    MAX_N_PLAYERS,
    MKT_BOARD_SLOTS,
    N_BUYABLETYPES,
    N_CARDTYPES,
    CardType,
    TurnPhase,
)
from ..ops import rng as R
from . import cells as C
from . import tables as T
from .mapgen import generate_map

_i32 = jnp.int32
# The reference's u_char state is held as int32 (a layout chosen for an
# earlier kernel compiler; ROADMAP C2); every arithmetic site that can
# leave [0, 255] applies _wrap8, preserving the uint8 wraparound
# semantics bit for bit.
_u8 = jnp.int32
_f32 = jnp.float32


def _wrap8(x):
    return x & 0xFF


# mask head offsets in the flat 92-bool mask (probe dump order)
PLAY0, SPECIAL0, REMOVE0, MOVE0, SHOP0 = 0, 22, 44, 66, 73
MASK_LEN = 92
PILE_DRAW, PILE_HAND, PILE_ACTIVE, PILE_PLAYED, PILE_DISCARD = range(5)

# static tables
# numpy (not jnp): trace-time constants, folded into each program
_CARD_RES = np.asarray(T.CARD_RES, np.float32)     # (21,3)
_CARD_COST = np.asarray(T.CARD_COST, np.float32)   # (21,)
_CARD_SINGLE = np.asarray(T.CARD_SINGLE_USE)       # (21,)
_CARD_IS_SPECIAL = np.asarray(T.CARD_IS_SPECIAL)   # (21,)
_CARD_SPECIAL = np.asarray(T.CARD_SPECIAL, np.int32)
_SHOP_TYPE = np.asarray(T.SHOP_CARD_TYPE, np.int32)
_SHOP_COST = np.asarray(T.SHOP_COST, np.float32)
_SHOP_MKT0 = np.asarray(T.SHOP_STARTS_IN_MARKET)
# card type -> shop-buyable resource cost table padded to 21 (for one-hot)
_DIR_DBL = np.asarray(
    [(0, 0), (2, 0), (0, 2), (-2, 2), (-2, 0), (0, -2), (2, -2)], np.int32)

# 2-hop hex neighbourhood ("ball"): every cell reachable as a+b for unit
# direction offsets a, b (incl. null). The step's only map dependence is this
# 19-cell ball per player, which lets the hot path consume *pregathered*
# cells — the blocked rollout scan (vec._KernelPrograms) never touches the
# 48x48 map inside the step.
_BALL_LIST = []
for _a in ((0, 0), (2, 0), (0, 2), (-2, 2), (-2, 0), (0, -2), (2, -2)):
    for _b in ((0, 0), (2, 0), (0, 2), (-2, 2), (-2, 0), (0, -2), (2, -2)):
        _o = (_a[0] + _b[0], _a[1] + _b[1])
        if _o not in _BALL_LIST:
            _BALL_LIST.append(_o)
N_BALL = len(_BALL_LIST)  # 19
_BALL = np.asarray(_BALL_LIST, np.int32)               # (19,2)
_PAIR = np.asarray(
    [[_BALL_LIST.index((_a[0] + _b[0], _a[1] + _b[1]))
      for _b in ((0, 0), (2, 0), (0, 2), (-2, 2), (-2, 0), (0, -2), (2, -2))]
     for _a in ((0, 0), (2, 0), (0, 2), (-2, 2), (-2, 0), (0, -2), (2, -2))],
    np.int32)                                          # (7,7) dir-pair -> ball idx

_IOTA4 = np.arange(MAX_N_PLAYERS)
_IOTA21 = np.arange(N_CARDTYPES)
_IOTA92 = np.arange(MASK_LEN)
_IOTA18 = np.arange(N_BUYABLETYPES)
_IOTA3 = np.arange(3)


def _oh(i, iota):
    """Boolean one-hot against a cached iota."""
    return iota == i


def _row(arr2d, p):
    """arr2d[(4, k)][p] without a gather: masked max (exactly one live row,
    the rest contribute 0)."""
    return jnp.max(jnp.where(_oh(p, _IOTA4[:, None]), arr2d,
                             jnp.zeros_like(arr2d)), axis=0)


def _put_row(arr2d, p, row):
    return jnp.where(_oh(p, _IOTA4[:, None]), row[None, :], arr2d)


def _set1(arr, i, val, iota):
    return jnp.where(_oh(i, iota), val, arr)


def _add1(arr, i, delta, iota):
    """Wrapping add of ``delta`` at position i (dtype of arr)."""
    return arr + jnp.where(_oh(i, iota), delta,
                           jnp.zeros((), arr.dtype)).astype(arr.dtype)


def _get1(arr, i, iota):
    """arr[i] with a traced index; bool/unsigned dtypes reduce through
    i32."""
    dt = arr.dtype
    if dt in (jnp.bool_, jnp.uint8, jnp.uint32):
        v = jnp.max(jnp.where(_oh(i, iota), arr.astype(_i32),
                              jnp.zeros((), _i32)))
        return (v > 0) if dt == jnp.bool_ else v.astype(dt)
    return jnp.max(jnp.where(_oh(i, iota), arr, jnp.zeros_like(arr)))


def _max2(x):
    """Full max over the last two axes as two single-axis reductions."""
    return jnp.max(jnp.max(x, axis=-1), axis=-1)


def _any1(x):
    """Scalar any() over a bool array, as an i32 sum."""
    return jnp.sum(x.astype(_i32)) > 0


def _brow(arr2d, p):
    """Row p of a (4, k) bool array without a bool/unsigned reduction."""
    return jnp.max(jnp.where(_oh(p, _IOTA4[:, None]), arr2d.astype(_i32),
                             jnp.zeros((), _i32)), axis=0) > 0


def _wrow(arr2d, p):
    """Row p of a (4, k) i32 array, sign-safe (packed mask words carry
    set bits in the sign position): sum over the one-hot, the three dead
    rows contribute 0."""
    return jnp.sum(jnp.where(_oh(p, _IOTA4[:, None]), arr2d, 0), axis=0)


def _u8row(arr, p):
    """Row p of a (4, ...) u8 array via an i32 reduction."""
    oh = _oh(p, _IOTA4.reshape((MAX_N_PLAYERS,) + (1,) * (arr.ndim - 1)))
    return jnp.max(jnp.where(oh, arr.astype(_i32), jnp.zeros((), _i32)),
                   axis=0).astype(_u8)


_IOTA5 = np.arange(5)


def _pile_add(piles, row, delta):
    """piles (4,5,21) += delta (4,21) at static pile row, scatter-free,
    with uint8 wraparound."""
    rm = _IOTA5[None, :, None] == row
    return _wrap8(piles + jnp.where(rm, delta[:, None, :],
                                    jnp.zeros((), _u8)))


def _csum_incl(x_i32):
    """Inclusive prefix sum along the last axis, in exact int32."""
    return jnp.cumsum(x_i32, axis=-1, dtype=_i32)


class EnvState(NamedTuple):
    rng: jnp.ndarray            # u32 engine state
    # reset params (fixed across auto-resets)
    n_players: jnp.ndarray      # i32
    n_pieces: jnp.ndarray       # i32
    difficulty: jnp.ndarray     # i32
    max_steps: jnp.ndarray      # i32
    # map — canonical flat (2304,) i32 cell-type-id plane (core/cells.py);
    # cells.expand_obs re-creates the reference-ABI (48,48,7) u8 layout at
    # cold boundaries (compat, goldens, render) only
    map_ids: jnp.ndarray        # (2304,) i32
    min_xy: jnp.ndarray         # (2,) i32 doubled
    player_xy: jnp.ndarray      # (4,2) i32 doubled
    map_ok: jnp.ndarray         # bool
    map_overflow: jnp.ndarray   # bool: procgen hit a fixed-capacity cap
    # decks
    piles: jnp.ndarray          # (4,5,21) u8
    n_in_hand: jnp.ndarray      # (4,) u8
    n_active: jnp.ndarray       # (4,) u8
    n_in_draw: jnp.ndarray      # (4,) u8
    idx_last: jnp.ndarray       # (4,) u8
    # player flags / stats
    has_won: jnp.ndarray        # (4,) bool
    mip: jnp.ndarray            # (4,) bool (movement_in_progress)
    next_card_free: jnp.ndarray # (4,) bool
    next_move_free: jnp.ndarray # (4,) bool
    n_removes: jnp.ndarray      # (4,) u8
    steps_taken: jnp.ndarray    # (4,) u8
    n_movements: jnp.ndarray    # (4,) i32
    n_added: jnp.ndarray        # (4,) u8
    # shop
    shop_stock: jnp.ndarray     # (18,) u8
    in_market: jnp.ndarray      # (18,) bool
    n_in_market: jnp.ndarray    # u8
    # turn
    phase: jnp.ndarray          # i32
    agent: jnp.ndarray          # i32
    resources: jnp.ndarray      # (3,) f32
    turn_counter: jnp.ndarray   # i32
    done: jnp.ndarray           # bool
    # masks (both bit-packed; unpack_mask at API boundaries)
    sel_mask: jnp.ndarray       # (3,) i32 packed words (pack_mask)
    storage_masks: jnp.ndarray  # (4,3) i32 packed rows (pack_mask)
    # per-player packed one-hop words (pack_ball_words w3 layout): player
    # j's six 1-hop cell-type ids + own is_end AT THEIR CURRENT POSITION.
    # Maintained by reset (w3_words_all) and by step (the current agent's
    # row refreshes from the pregathered ball every step, and a player's
    # position only changes on their own turn, so rows are never stale
    # when read). Lets the rollout's per-step map read be ONE row gather
    # at the agent's cell instead of a second gather at the next agent's.
    w3_cache: jnp.ndarray       # (4,) i32
    # outputs (persist across resets)
    rewards: jnp.ndarray        # (4,) f32
    info_total: jnp.ndarray     # i32
    info_steps: jnp.ndarray     # (4,) u8
    info_returns: jnp.ndarray   # (4,) f32
    info_travelled: jnp.ndarray # (4,) i32
    info_added: jnp.ndarray     # (4,) u8
    info_removed: jnp.ndarray   # (4,) u8
    info_card_uses: jnp.ndarray # (4,) i32
    rng_tainted: jnp.ndarray    # bool: a double rejection ever deviated a draw


def _select(pred, a, b):
    """tree_map where(pred, a, b); leaves untouched by the taken branch are
    the same tracer object on both sides and skip the select entirely —
    without this, every branch merge copies the full state (including the
    16KB/env map observation) and the step becomes HBM-bound."""
    pred32 = pred.astype(_i32) if hasattr(pred, "astype") else pred

    def pick(x, y):
        if x is y:
            return x
        if x.ndim == 0:
            return jnp.where(pred, x, y)
        # expand through i32: vmap turns this scalar reshape into one
        p = jnp.reshape(pred32, (1,) * x.ndim) == 1
        return jnp.where(p, x, y)
    return jax.tree_util.tree_map(pick, a, b)


def _merge(base, *branches):
    """Flat N-way branch merge: ``branches`` are (pred, tree) pairs with
    mutually-exclusive predicates; leaves a branch left untouched (same
    tracer as ``base``) cost nothing, and a leaf touched by k branches
    costs exactly k selects. The nested ``_select(p1, f1, _select(p2, f2,
    ...))`` cascade this replaces charged up to N selects per leaf for
    every leaf any deeper branch touched (each level re-wraps the inner
    merge's fresh tracer)."""
    leaves_b, treedef = jax.tree_util.tree_flatten(base)
    leaves_v = [jax.tree_util.tree_flatten(v)[0] for _, v in branches]
    preds32 = [(p, p.astype(_i32) if hasattr(p, "astype") else p)
               for p, _ in branches]
    out = []
    for i, lb in enumerate(leaves_b):
        val = lb
        for (pred, pred32), lv in zip(preds32, (l[i] for l in leaves_v)):
            if lv is lb:
                continue
            if np.ndim(lv) == 0:
                val = jnp.where(pred, lv, val)
            else:
                p = jnp.reshape(pred32, (1,) * np.ndim(lv)) == 1
                val = jnp.where(p, lv, val)
        out.append(val)
    return treedef.unflatten(out)


_NULL_MASK = np.zeros(MASK_LEN, bool)
_NULL_MASK[[PLAY0, SPECIAL0, REMOVE0, MOVE0, SHOP0]] = True
# per-head membership of the flat mask (static constants)
_IN_PLAY = (_IOTA92 >= PLAY0) & (_IOTA92 < PLAY0 + 22)
_IN_SPECIAL = (_IOTA92 >= SPECIAL0) & (_IOTA92 < SPECIAL0 + 22)
_IN_REMOVE = (_IOTA92 >= REMOVE0) & (_IOTA92 < REMOVE0 + 22)
_IN_MOVE = (_IOTA92 >= MOVE0) & (_IOTA92 < MOVE0 + 7)
_IN_SHOP = (_IOTA92 >= SHOP0) & (_IOTA92 < SHOP0 + 19)


def _mask_reset(m):
    """ActionMask::reset (include/api.h:104-118): play/special/remove heads
    cleared; move/shop heads keep indices 1.. apart from index 0."""
    cleared = _IN_PLAY | _IN_SPECIAL | _IN_REMOVE
    return jnp.where(cleared, _NULL_MASK, m | _NULL_MASK)


def init_mask():
    return _mask_reset(jnp.zeros(MASK_LEN, bool))


# ---- packed mask words -------------------------------------------------
# storage_masks live in the state as 3 i32 words per player (92 bits,
# 4 spare): the step only ever selects/saves whole rows, and one-hot
# row select/scatter on (4, 92) bools is ~13x the element work of (4, 3)
# words + one unpack of the agent's row.
_POW32 = np.arange(32, dtype=np.int32)
MASK_WORDS = (MASK_LEN + 31) // 32


def pack_mask(bits):
    """(..., 92) bool -> (..., 3) i32 little-endian bit words."""
    x = bits.astype(_i32)
    pad = jnp.zeros(x.shape[:-1] + (32 * MASK_WORDS - MASK_LEN,), _i32)
    x = jnp.concatenate([x, pad], -1)
    x = x.reshape(x.shape[:-1] + (MASK_WORDS, 32))
    return jnp.sum(x << _POW32, axis=-1)


def unpack_mask(words):
    """(..., 3) i32 -> (..., 92) bool."""
    u = (words[..., None] >> _POW32) & 1
    u = u.reshape(words.shape[:-1] + (32 * MASK_WORDS,))
    return u[..., :MASK_LEN] != 0


# ---- packed-word mask algebra ------------------------------------------
# The step's WORKING masks (sel + the per-player storage rows it edits)
# ride as (3,) i32 words end to end: the same updates on 3 words
# instead of (92,) bools touch ~30x fewer elements. Bit positions can sit in the sign bit — all
# algebra is & | ^ ~ and shifts, and addition of DISTINCT bit positions
# (two's complement) equals OR, so packing sums are carry-free.
_IOTA3W = np.arange(MASK_WORDS)


def _np_pack_mask(bits):
    """numpy pack_mask for static constants."""
    x = np.zeros(32 * MASK_WORDS, np.int64)
    x[:MASK_LEN] = np.asarray(bits, np.int64)
    w = (x.reshape(MASK_WORDS, 32) << np.arange(32)).sum(-1)
    return (w & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _head_mask_w(off, width):
    m = np.zeros(MASK_LEN, bool)
    m[off:off + width] = True
    return _np_pack_mask(m)


_NULL_W = _np_pack_mask(_NULL_MASK)
_CLEAR_PSR_W = _head_mask_w(PLAY0, 66)   # play+special+remove heads


def _mask_reset_w(m):
    """ActionMask::reset on packed words (see _mask_reset)."""
    return (m & ~_CLEAR_PSR_W) | _NULL_W


def _bit_mask_w(pos):
    """(3,) i32 with (traced) bit ``pos`` set in its word."""
    return jnp.where(_IOTA3W == (pos >> 5),
                     jax.lax.shift_left(jnp.int32(1), pos & 31),
                     jnp.int32(0))


def _bit_get_w(w, pos):
    """Bool value of (traced) bit ``pos`` of a (3,) word vector."""
    return jnp.sum(jnp.where((w & _bit_mask_w(pos)) != 0, 1, 0)) > 0


def _bit_put_w(w, pos, bit):
    """Set (traced) bit ``pos`` to (traced bool) ``bit``."""
    m = _bit_mask_w(pos)
    return (w & ~m) | jnp.where(bit, m, jnp.int32(0))


def _pack_head_w(bits, off):
    """(k,) bool/int head -> (3,) words with the head at static ``off``
    (addition of distinct bit positions == OR, carry-free)."""
    k = bits.shape[-1]
    pos = off + np.arange(k)
    jk, sk = pos >> 5, (pos & 31).astype(np.int32)
    sh = jax.lax.shift_left(bits.astype(_i32), sk)
    return jnp.stack([jnp.sum(jnp.where(jk == j, sh, 0))
                      for j in range(MASK_WORDS)])


def _set_head_w(w, bits, off):
    """Replace head bits [off, off+k) of ``w`` with ``bits``."""
    return ((w & ~_head_mask_w(off, int(bits.shape[-1])))
            | _pack_head_w(bits, off))


def _head_field_w(w, off, width):
    """Extract head bits [off, off+width) (width <= 22) as one scalar."""
    j0, sh = off >> 5, off & 31
    f = jax.lax.shift_right_logical(w[j0], np.int32(sh))
    if sh + width > 32:
        f = f | jax.lax.shift_left(w[j0 + 1], np.int32(32 - sh))
    return f & ((1 << width) - 1)


def make_state(seed=0, n_players=4, n_pieces=3, difficulty=0,
               max_steps=100000) -> EnvState:
    """Freshly-constructed env + zeroed external buffers (probe layout:
    everything zero except ActionMask constructors)."""
    z4u8 = jnp.zeros(4, _u8)
    return EnvState(
        rng=R.seed(seed),
        n_players=jnp.asarray(n_players, _i32),
        n_pieces=jnp.asarray(n_pieces, _i32),
        difficulty=jnp.asarray(difficulty, _i32),
        max_steps=jnp.asarray(max_steps, _i32),
        map_ids=jnp.zeros((GRIDSIZE * GRIDSIZE,), _i32),
        min_xy=jnp.zeros(2, _i32),
        player_xy=jnp.zeros((4, 2), _i32),
        map_ok=jnp.bool_(True),
        map_overflow=jnp.bool_(False),
        piles=jnp.zeros((4, 5, N_CARDTYPES), _u8),
        n_in_hand=z4u8, n_active=z4u8, n_in_draw=z4u8, idx_last=z4u8,
        has_won=jnp.zeros(4, bool), mip=jnp.zeros(4, bool),
        next_card_free=jnp.zeros(4, bool), next_move_free=jnp.zeros(4, bool),
        n_removes=z4u8, steps_taken=z4u8,
        n_movements=jnp.zeros(4, _i32), n_added=z4u8,
        shop_stock=jnp.full(18, 3, _u8),
        in_market=_SHOP_MKT0,
        n_in_market=jnp.asarray(MKT_BOARD_SLOTS, _u8),
        phase=jnp.asarray(0, _i32), agent=jnp.asarray(0, _i32),
        resources=jnp.zeros(3, _f32),
        turn_counter=jnp.asarray(0, _i32), done=jnp.bool_(False),
        sel_mask=pack_mask(init_mask()),
        storage_masks=jnp.tile(pack_mask(init_mask())[None], (4, 1)),
        w3_cache=jnp.zeros(4, _i32),
        rewards=jnp.zeros(4, _f32),
        info_total=jnp.asarray(0, _i32), info_steps=z4u8,
        info_returns=jnp.zeros(4, _f32), info_travelled=jnp.zeros(4, _i32),
        info_added=z4u8, info_removed=z4u8,
        info_card_uses=jnp.zeros(4, _i32),
        rng_tainted=jnp.bool_(False))


def _sel_card_bits(sel_w, idx, play_bit, special_bit, remove_bit=None):
    """Set sel bit PLAY0+1+idx, SPECIAL0+1+idx (and optionally
    REMOVE0+1+idx) on the packed (3,) word mask."""
    out = _bit_put_w(sel_w, PLAY0 + 1 + idx, play_bit)
    out = _bit_put_w(out, SPECIAL0 + 1 + idx, special_bit)
    if remove_bit is not None:
        out = _bit_put_w(out, REMOVE0 + 1 + idx, remove_bit)
    return out


# --------------------------------------------------------------- player view
class PView(NamedTuple):
    """The current player's projected slice plus the shared step mutables.

    The reference mutates one player object per step
    (src/environment.cpp:91-224); the lockstep form used to express that as
    one-hot-masked updates over the full (4,5,21)/(4,92) arrays at every
    update site (~150 sites). Projecting player p ONCE, running the whole
    branch logic on (21,)/(92,)/scalar values, and embedding the result back
    in a single pass removes ~4x of the step's element traffic and a third
    of its op count.
    """
    # projected player p (u8-domain values held as i32, see _u8)
    draw: jnp.ndarray            # (21,)
    hand: jnp.ndarray            # (21,)
    active: jnp.ndarray          # (21,)
    played: jnp.ndarray          # (21,)
    discard: jnp.ndarray         # (21,)
    n_in_hand: jnp.ndarray       # scalar
    n_active: jnp.ndarray        # scalar
    n_in_draw: jnp.ndarray       # scalar
    idx_last: jnp.ndarray        # scalar
    xy: jnp.ndarray              # (2,) i32
    storage: jnp.ndarray         # (3,) i32 — player p's stored mask words
    has_won: jnp.ndarray         # scalar bool
    mip: jnp.ndarray             # scalar bool
    next_card_free: jnp.ndarray  # scalar bool
    next_move_free: jnp.ndarray  # scalar bool
    n_removes: jnp.ndarray       # scalar
    n_movements: jnp.ndarray     # scalar i32
    n_added: jnp.ndarray         # scalar
    # shared
    sel: jnp.ndarray             # (3,) i32 — selected action mask words
    resources: jnp.ndarray       # (3,) f32
    phase: jnp.ndarray           # scalar i32
    shop_stock: jnp.ndarray      # (18,)
    in_market: jnp.ndarray       # (18,) bool
    n_in_market: jnp.ndarray     # scalar
    rng: jnp.ndarray
    tainted: jnp.ndarray


def _pview(s: EnvState, p) -> PView:
    piles_p = _u8row(s.piles, p)                       # (5,21)
    rows = [jax.lax.squeeze(
        jax.lax.slice(piles_p, (r, 0), (r + 1, N_CARDTYPES)), (0,))
        for r in range(5)]
    xy = jnp.max(jnp.where(_oh(p, _IOTA4[:, None]), s.player_xy,
                           jnp.full_like(s.player_xy, -(1 << 20))), axis=0)
    g = lambda arr: _get1(arr, p, _IOTA4)
    return PView(
        draw=rows[PILE_DRAW], hand=rows[PILE_HAND], active=rows[PILE_ACTIVE],
        played=rows[PILE_PLAYED], discard=rows[PILE_DISCARD],
        n_in_hand=g(s.n_in_hand), n_active=g(s.n_active),
        n_in_draw=g(s.n_in_draw), idx_last=g(s.idx_last),
        xy=xy, storage=_wrow(s.storage_masks, p),
        has_won=g(s.has_won), mip=g(s.mip),
        next_card_free=g(s.next_card_free),
        next_move_free=g(s.next_move_free),
        n_removes=g(s.n_removes), n_movements=g(s.n_movements),
        n_added=g(s.n_added),
        sel=s.sel_mask, resources=s.resources, phase=s.phase,
        shop_stock=s.shop_stock, in_market=s.in_market,
        n_in_market=s.n_in_market, rng=s.rng, tainted=s.rng_tainted)


def _pview_embed(s: EnvState, p, v: PView) -> EnvState:
    """Write the projected slice back (single pass per leaf)."""
    oh_p = _oh(p, _IOTA4)
    new_p = jnp.stack([v.draw, v.hand, v.active, v.played, v.discard])
    sput = lambda arr, val: jnp.where(oh_p, val, arr)
    bput = lambda arr, val: (arr & ~oh_p) | (oh_p & val)
    return s._replace(
        piles=jnp.where(_oh(p, _IOTA4[:, None, None]), new_p[None], s.piles),
        n_in_hand=sput(s.n_in_hand, v.n_in_hand),
        n_active=sput(s.n_active, v.n_active),
        n_in_draw=sput(s.n_in_draw, v.n_in_draw),
        idx_last=sput(s.idx_last, v.idx_last),
        player_xy=jnp.where(_oh(p, _IOTA4[:, None]), v.xy[None],
                            s.player_xy),
        storage_masks=_put_row(s.storage_masks, p, v.storage),
        has_won=bput(s.has_won, v.has_won),
        mip=bput(s.mip, v.mip),
        next_card_free=bput(s.next_card_free, v.next_card_free),
        next_move_free=bput(s.next_move_free, v.next_move_free),
        n_removes=sput(s.n_removes, v.n_removes),
        n_movements=sput(s.n_movements, v.n_movements),
        n_added=sput(s.n_added, v.n_added),
        sel_mask=v.sel, resources=v.resources, phase=v.phase,
        shop_stock=v.shop_stock, in_market=v.in_market,
        n_in_market=v.n_in_market, rng=v.rng, rng_tainted=v.tainted)


# ---------------------------------------------------------------------- deck
def _deck_draw_p(v: PView, n) -> PView:
    """Deck::draw (src/cards.cpp:183-211): recycle at most once, clamp, then
    up to four uniform picks scanning the draw-pile counts."""
    nid0 = v.n_in_draw
    need = nid0 < n
    rec_nid = _wrap8(nid0 + jnp.sum(v.discard))
    draw = jnp.where(need, _wrap8(v.draw + v.discard), v.draw)
    discard = jnp.where(need, jnp.zeros(N_CARDTYPES, _u8), v.discard)
    nid = jnp.where(need, rec_nid, nid0)
    hand = v.hand
    n_eff = jnp.minimum(n, nid)
    sel = v.sel
    rng = v.rng
    taint = v.tainted
    one = jnp.asarray(1, _u8)
    # ONE inclusive prefix sum per call; each live draw decrements the
    # prefix at positions >= the drawn type (exact integer identity with
    # recomputing _csum_incl on the updated pile, which would cost one
    # prefix sum per UNROLLED draw)
    cum = _csum_incl(draw)
    for k in range(HAND_SIZE):  # static unroll: at most 4 draws per call
        live = k < n_eff
        t, rng, tt = R.uniform_int_fast_maybe(rng, nid, live)
        taint = taint | tt
        ct = jnp.sum(cum <= t.astype(_i32), dtype=_i32)
        ct = jnp.minimum(ct, N_CARDTYPES - 1)
        oh_ct = _oh(ct, _IOTA21)
        dlt = jnp.where(live & oh_ct, one, jnp.zeros((), _u8))
        draw = _wrap8(draw - dlt)
        hand = _wrap8(hand + dlt)
        cum = jnp.where(live, cum - (_IOTA21 >= ct).astype(cum.dtype), cum)
        nid = jnp.where(live, _wrap8(nid - one), nid)
        # packed-word bit updates; the special bit is rewritten only on
        # live draws (matches the old masked tgt_sp form)
        sel = sel | jnp.where(live, _bit_mask_w(PLAY0 + 1 + ct),
                              jnp.int32(0))
        msp = _bit_mask_w(SPECIAL0 + 1 + ct)
        new_sp = (sel & ~msp) | jnp.where(
            _get1(_CARD_IS_SPECIAL, ct, _IOTA21), msp, jnp.int32(0))
        sel = jnp.where(live, new_sp, sel)
    return v._replace(draw=draw, hand=hand, discard=discard, n_in_draw=nid,
                      n_in_hand=_wrap8(v.n_in_hand + n_eff),
                      sel=sel, rng=rng, tainted=taint)


def _deck_draw(s: EnvState, p, n) -> EnvState:
    """Reset-path wrapper: project, draw, embed."""
    return _pview_embed(s, p, _deck_draw_p(_pview(s, p), jnp.asarray(n,
                                                                     _i32)))


def _activate_p(v: PView, idx) -> PView:
    """Deck::activate (src/cards.cpp:242-253)."""
    oh_c = _oh(idx, _IOTA21)
    prev = _get1(v.hand, idx, _IOTA21)
    one = jnp.asarray(1, _u8)
    dlt = jnp.where(oh_c, one, jnp.zeros((), _u8))
    return v._replace(
        hand=_wrap8(v.hand - dlt), active=_wrap8(v.active + dlt),
        n_in_hand=_wrap8(v.n_in_hand - one),
        n_active=_wrap8(v.n_active + one),
        idx_last=idx,
        sel=_sel_card_bits(
            v.sel, idx, prev > 1,
            (prev > 1) & _get1(_CARD_IS_SPECIAL, idx, _IOTA21)))


def _play_last_activated_p(v: PView) -> PView:
    """src/cards.cpp:255-261."""
    idx = v.idx_last
    oh_c = _oh(idx, _IOTA21)
    one = jnp.asarray(1, _u8)
    single_i = _get1(_CARD_SINGLE.astype(np.int32), idx, _IOTA21)
    return v._replace(
        active=_wrap8(v.active - jnp.where(oh_c, one, jnp.zeros((), _u8))),
        played=_wrap8(v.played + jnp.where(oh_c & (single_i == 0), one,
                                           jnp.zeros((), _u8))),
        n_active=_wrap8(v.n_active - one))


def _play_immediate_p(v: PView, idx) -> PView:
    """src/cards.cpp:263-273."""
    oh_c = _oh(idx, _IOTA21)
    prev = _get1(v.hand, idx, _IOTA21)
    one = jnp.asarray(1, _u8)
    dlt = jnp.where(oh_c, one, jnp.zeros((), _u8))
    return v._replace(
        hand=_wrap8(v.hand - dlt), played=_wrap8(v.played + dlt),
        n_in_hand=_wrap8(v.n_in_hand - one),
        sel=_sel_card_bits(
            v.sel, idx, prev > 1,
            (prev > 1) & _get1(_CARD_IS_SPECIAL, idx, _IOTA21)))


def _remove_immediate_p(v: PView, idx) -> PView:
    """src/cards.cpp:281-290."""
    oh_c = _oh(idx, _IOTA21)
    prev = _get1(v.hand, idx, _IOTA21)
    one = jnp.asarray(1, _u8)
    play_bit = _bit_get_w(v.sel, PLAY0 + 1 + idx) & (prev > 1)
    remove_bit = _bit_get_w(v.sel, REMOVE0 + 1 + idx) & (prev > 1)
    return v._replace(
        hand=_wrap8(v.hand - jnp.where(oh_c, one, jnp.zeros((), _u8))),
        n_in_hand=_wrap8(v.n_in_hand - one),
        sel=_sel_card_bits(
            v.sel, idx, play_bit,
            play_bit & _get1(_CARD_IS_SPECIAL, idx, _IOTA21),
            remove_bit=remove_bit))


def _pick_actives_p(v: PView, n, to_discard) -> PView:
    """Player::discard_cards / remove_cards (src/player.cpp:85-131): n uniform
    picks over the active counts; remove clamps n to n_active, discard does
    not (unreachable overflow per the mod-256 invariant)."""
    n_avail = v.n_active
    n = jnp.where(to_discard, n, jnp.minimum(n, n_avail))
    active, discard, n_act = v.active, v.discard, v.n_active
    rng, taint = v.rng, v.tainted
    one = jnp.asarray(1, _u8)
    for k in range(5):  # static unroll: n_required <= 5 picks per call
        live = k < n
        t, rng, tt = R.uniform_int_fast_maybe(rng, n_avail - k, live)
        taint = taint | tt
        cum = _csum_incl(active)
        ct = jnp.sum(cum <= t.astype(_i32), dtype=_i32)
        ct = jnp.minimum(ct, N_CARDTYPES - 1)
        oh_ct = _oh(ct, _IOTA21)
        active = _wrap8(active - jnp.where(live & oh_ct, one,
                                           jnp.zeros((), _u8)))
        discard = _wrap8(discard + jnp.where(live & to_discard & oh_ct, one,
                                             jnp.zeros((), _u8)))
        n_act = jnp.where(live, _wrap8(n_act - one), n_act)
    return v._replace(active=active, discard=discard, n_active=n_act,
                      rng=rng, tainted=taint)


# --------------------------------------------------------------------- masks
_PLAYSP_W = _head_mask_w(PLAY0, 44)     # play + special heads
_REMOVE_W = _head_mask_w(REMOVE0, 22)


def _disable_playing_p(v: PView) -> PView:
    """src/player.cpp:191-196 (selected mask, packed words)."""
    return v._replace(sel=(v.sel & ~_PLAYSP_W) | (_NULL_W & _PLAYSP_W))


def _enable_playing_p(v: PView) -> PView:
    """src/player.cpp:198-206 (selected mask, packed words)."""
    play = v.hand > 0                                 # (21,)
    sel = (v.sel & ~_REMOVE_W) | (_NULL_W & _REMOVE_W)
    sel = _set_head_w(sel, play, PLAY0 + 1)
    sel = _set_head_w(sel, play & _CARD_IS_SPECIAL, SPECIAL0 + 1)
    return v._replace(sel=sel)


def _shop_avail(shop_stock, in_market, n_in_market, coins):
    """Shop::set_available_mask -> 18 bools (src/cards.cpp:109-121)."""
    open_slots = n_in_market < MKT_BOARD_SLOTS
    afford = coins > _SHOP_COST
    return jnp.where(open_slots, (shop_stock > 0) & afford,
                     in_market & afford)


def _shop_available(s: EnvState, coins):
    return _shop_avail(s.shop_stock, s.in_market, s.n_in_market, coins)


def _cells(s: EnvState, xy):
    """Hex features at doubled coords xy (..., 2): (req, n_req, is_end).
    Reproduces the reference's size_t truncation of half-integer offsets
    (src/map.cpp:273-275): d>=0 -> d//2+1; d==-1 -> 1; d<=-2 -> 0.
    One i32 id gather per point (off-grid reads sentinel id 0), decoded
    by shift/mask LUT arithmetic — no 7-channel layout anywhere."""
    d = xy - s.min_xy
    idx = jnp.where(d >= 0, (d >> 1) + 1, jnp.where(d == -1, 1, 0))
    ix, iy = idx[..., 0], idx[..., 1]
    in_grid = (ix >= 0) & (ix < GRIDSIZE) & (iy >= 0) & (iy < GRIDSIZE)
    lin = (jnp.clip(ix, 0, GRIDSIZE - 1) * GRIDSIZE
           + jnp.clip(iy, 0, GRIDSIZE - 1))
    tid = jnp.where(in_grid, s.map_ids[lin], 0)
    return _decode_cells(tid)


def _ball_cells(s: EnvState):
    """Pregather (req, n_req, is_end) for every player's 19-cell 2-hop ball
    from the map id plane. Single-env; vmap for batches. This is the
    step's entire map read set (move target, movement masks after at most
    one hop, end-of-game check)."""
    return _ball_cells_xy(s.map_ids, s.min_xy, s.player_xy)


def _ball_cells_xy(map_ids, min_xy, player_xy):
    """_ball_cells from explicit (map_ids, min_xy, player_xy) — the only
    state it reads. Lets rollout drivers that keep the rest of the state in
    a blocked layout pregather from just the positions. One id
    gather per ball point (76 elements/env vs 532 in the 7-channel
    layout), decoded by LUT shifts."""
    tgt = player_xy[:, None, :] + _BALL[None, :, :]            # (4,19,2)
    d = tgt - min_xy
    idx = jnp.where(d >= 0, (d >> 1) + 1, jnp.where(d == -1, 1, 0))
    ix, iy = idx[..., 0], idx[..., 1]
    in_grid = (ix >= 0) & (ix < GRIDSIZE) & (iy >= 0) & (iy < GRIDSIZE)
    lin = (jnp.clip(ix, 0, GRIDSIZE - 1) * GRIDSIZE
           + jnp.clip(iy, 0, GRIDSIZE - 1))
    tid = jnp.where(in_grid, map_ids[lin], 0)
    return _decode_cells(tid)                                  # each (4,19)


# ---- cell-type encoding ----------------------------------------------
# Canonical map representation: the 5-bit cell-type-id plane (see
# core/cells.py — moved there so mapgen can emit ids directly). The
# names below are re-exported for the existing engine surface.
cell_type_ids = C.cell_type_ids
_decode_cells = C.decode_cells
expand_obs = C.expand_obs
ids_from_obs = C.ids_from_obs
_CELL_TRIPLES = C._CELL_TRIPLES
N_CELL_TYPES = C.N_CELL_TYPES
_END_L = C._END_L


def pack_ball_words(pids, pend0):
    """Pack one step's map read into 4 i32 words: p's 19 ball-cell ids at
    bits [5k, 5k+5) of the little-endian 96-bit w0..w2 field (cells 6 and
    12 straddle word boundaries), and p's OWN one-hop word w3: the six
    1-hop ids (``pids`` indices 1..6 — the unit directions lead the _BALL
    order) at w3 bits [5(i-1), 5i) plus p's own is_end at w3 bit 30.

    w3 is the w3_cache row format: the step refreshes the current agent's
    cache row with it and reads the NEXT agent's one-hop data from the
    cache (their row was refreshed on their own last step — positions
    only change on a player's own turn), so rollout drivers gather ONE
    contiguous 4-word row per env per step (pack_ball_word_table)."""
    ws = []
    for j in range(3):
        w = jnp.zeros_like(pids[..., 0])
        for k in range(N_BALL):
            lo = 5 * k - 32 * j
            if -4 <= lo <= 31:
                idk = pids[..., k]
                w = w | (idk << lo if lo >= 0 else idk >> -lo)
        ws.append(w)
    # accumulate the six id fields FIRST and fold the end bit in LAST:
    # seeding the or-chain with (end << 30) triggers an XLA wrong-code
    # bug (jax 0.9.0, seen on more than one backend) that silently drops the
    # <<20 term under jit (minimal repro + canary:
    # tests/test_ball_words.py::test_w3_fold_jit_parity)
    w3 = jnp.zeros_like(pids[..., 0])
    for i in range(6):
        w3 = w3 | (pids[..., 1 + i] << (5 * i))
    return ws[0], ws[1], ws[2], w3 | (pend0 << 30)


def _ball_p_ids(w0, w1, w2):
    """Unpack the current player's 19 ball-cell ids from the packed
    96-bit field: static shifts/masks only."""
    ws = (w0, w1, w2)
    cells = []
    for k in range(N_BALL):
        j, sh = divmod(5 * k, 32)
        c = (ws[j] >> sh) & 31
        if sh > 27:   # cell straddles into the next word
            c = (c & ((1 << (32 - sh)) - 1)) \
                | ((ws[j + 1] << (32 - sh)) & 31)
        cells.append(c)
    return jnp.stack(cells, axis=-1)                           # (19,)


def _ball_q_row(w3):
    """Next-agent pseudo ball row from their packed one-hop word
    (w3_cache row): real values at the six 1-hop indices (all the rotated
    mask rebuild reads, kidx = _PAIR[0][1:] = 1..6) plus q's own is_end
    at index 0 (the rotated done check's only read, k0 = _PAIR[0][0] =
    0); sentinel elsewhere."""
    qids = jnp.stack([(w3 >> (5 * i)) & 31 for i in range(6)], axis=-1)
    req6, nr6, end6 = _decode_cells(qids)
    end0 = jnp.reshape((w3 >> 30) & 1, (1,))
    req = jnp.concatenate([jnp.full((1,), 5, _i32), req6,
                           jnp.full((12,), 5, _i32)])
    nr = jnp.concatenate([jnp.zeros((1,), _i32), nr6,
                          jnp.zeros((12,), _i32)])
    end = jnp.concatenate([end0, end6, jnp.zeros((12,), _i32)])
    return req, nr, end


def ball_words(s: EnvState):
    """The step's ENTIRE map read, packed into 4 i32 words (see
    pack_ball_words): the current agent p's 19-cell 2-hop ball (w0..w2)
    plus p's own one-hop word (w3, the w3_cache row format). The next
    agent's one-hop data comes from s.w3_cache inside the step, so only
    ONE player's row of the (4, 19) pregather is consumed — rollout
    drivers gather one contiguous 4-word row per env per step
    (pack_ball_word_table). Single-env; vmap for batches."""
    ids = _ball_ids_xy(s.map_ids, s.min_xy, s.player_xy)       # (4, 19)
    p = s.agent
    oh_p = _oh(p, _IOTA4[:, None])
    pids = jnp.max(jnp.where(oh_p, ids, 0), axis=0)            # (19,)
    pend0 = (_END_L >> jnp.max(jnp.where(oh_p[:, 0], ids[:, 0], 0))) & 1
    return pack_ball_words(pids, pend0)


def w3_words_all(s: EnvState):
    """Every player's packed one-hop word at their current position —
    the w3_cache contents (see pack_ball_words). Reset-path helper;
    single-env, vmap for batches."""
    return w3_words_from_cells(*_ball_cells(s))                # (4,)


def _ball_ids_xy(map_ids, min_xy, player_xy):
    """Every player's 19-cell ball as raw cell-type ids (4, 19) — the
    id-plane gather of _ball_cells_xy without the triple decode."""
    tgt = player_xy[:, None, :] + _BALL[None, :, :]            # (4,19,2)
    d = tgt - min_xy
    idx = jnp.where(d >= 0, (d >> 1) + 1, jnp.where(d == -1, 1, 0))
    ix, iy = idx[..., 0], idx[..., 1]
    in_grid = (ix >= 0) & (ix < GRIDSIZE) & (iy >= 0) & (iy < GRIDSIZE)
    lin = (jnp.clip(ix, 0, GRIDSIZE - 1) * GRIDSIZE
           + jnp.clip(iy, 0, GRIDSIZE - 1))
    return jnp.where(in_grid, map_ids[lin], 0)


def pack_ball_word_table(map_ids):
    """Flat (2304,) id plane -> (72, 128) i32 tile-packed cell rows: cell
    c's 4 words (w0..w2 the 19-cell ball ids, w3 the six 1-hop ids +
    own is_end — the w3_cache row format) live at row c >> 5, lanes
    [(c & 31) * 4, +4). Cell-major rows let the rollout read the whole
    step's map dependence as ONE contiguous-row gather per env instead of
    one gather per element, and the 128-word minor dim keeps the stored
    table free of padding on layouts that tile the last dim.

    Stencil construction: every _BALL offset is even in both doubled
    coordinates and every hex in a connected map shares both coordinate
    parities, so in grid space (idx = (xy-min)//2 + 1, the
    src/map.cpp:389-405 rasterisation) the ball is a FIXED 19-point
    stencil with offsets _BALL//2 — 19 padded static shifts of the id
    plane, no gathers. Off-grid targets read the zero padding = sentinel
    id 0 = (5,0,0), which equals the never-rasterised border rows'
    value, so the table matches _ball_cells for every in-grid centre.

    The WORDS accumulate plane-by-plane (never a (..., 19) stacked array
    of raw ids, which is large HLO temp memory at thousands of envs).
    Single-env; vmap for batches."""
    ids = map_ids.reshape(GRIDSIZE, GRIDSIZE)
    end = (_END_L >> ids) & 1
    pad = jnp.pad(ids, 2)                                      # 0 = sentinel
    off = np.asarray(_BALL) // 2

    def plane(k):
        dx, dy = off[k]
        return pad[2 + dx:2 + dx + GRIDSIZE, 2 + dy:2 + dy + GRIDSIZE]

    ws = []
    for j in range(3):
        w = jnp.zeros((GRIDSIZE, GRIDSIZE), _i32)
        for k in range(N_BALL):
            lo = 5 * k - 32 * j
            if -4 <= lo <= 31:
                pk = plane(k)
                w = w | (pk << lo if lo >= 0 else pk >> -lo)
        ws.append(w.reshape(-1))
    # id fields first, end bit last (XLA fold bug — see pack_ball_words)
    w3 = jnp.zeros((GRIDSIZE, GRIDSIZE), _i32)
    for i in range(6):
        w3 = w3 | (plane(1 + i) << (5 * i))
    w3 = w3 | (end << 30)
    rows = jnp.stack([ws[0], ws[1], ws[2], w3.reshape(-1)], axis=-1)
    return rows.reshape(GRIDSIZE * GRIDSIZE // 32, 128)


def select_ball_words(row128, lane_base):
    """Pick cell c's 4 packed words out of its gathered 128-lane table
    row (pack_ball_word_table layout): ``row128`` (..., 128),
    ``lane_base`` (...,) = (c & 31) * 4. Sign-safe one-hot reduction
    (word bits reach the i32 sign position)."""
    w = lane_base[..., None] + jnp.arange(4, dtype=_i32)       # (..., 4)
    oh = jnp.arange(128, dtype=_i32) == w[..., None]           # (...,4,128)
    return jnp.sum(jnp.where(oh, row128[..., None, :], 0), axis=-1)


def _ball_at_p(ball_p, k):
    """ball-row entry (req, n_req, is_end) at ball index k."""
    breq, bnr, bend = ball_p
    m = _oh(k, np.arange(N_BALL))
    # req needs a min-style default of 5 (impassable), not 0
    req = jnp.max(jnp.where(m, breq, -1))
    req = jnp.where(req < 0, 5, req)
    return (req, jnp.max(jnp.where(m, bnr, jnp.zeros_like(bnr))),
            jnp.max(jnp.where(m, bend, jnp.zeros_like(bend))))


def _movement_mask_row(ball_p, m_eff, resources, n_active):
    """Map::set_movement_mask (src/map.cpp:369-387) against one player's
    pregathered ball row: probes the six 1-hop neighbours after an optional
    first hop ``m_eff`` (0 when the player did not move this step)."""
    row_req, row_nr, _ = ball_p
    # ball indices of (m_eff + k) for k = 1..6
    kidx = jnp.max(jnp.where(_oh(m_eff, np.arange(7)[:, None]), _PAIR,
                             jnp.zeros_like(_PAIR)), axis=0)[1:]   # (6,)
    onek = _oh(kidx[:, None], np.arange(N_BALL)[None, :])         # (6,19)
    req = jnp.max(jnp.where(onek, row_req[None, :], -1), axis=-1)
    req = jnp.where(req < 0, 5, req)
    n_req = jnp.max(jnp.where(onek, row_nr[None, :], 0), axis=-1)
    ridx = jnp.minimum(req, 2)
    res = jnp.where(ridx == 0, resources[0],
                    jnp.where(ridx == 1, resources[1], resources[2]))
    filled = jnp.where(req >= 3, n_active > n_req,
                       res >= n_req.astype(_f32))
    return (req != 5) & filled


def _movement_mask(s: EnvState, p, resources, n_active):
    """Map::set_movement_mask -> 6 bools for directions 1..6
    (src/map.cpp:369-387)."""
    pxy = jnp.max(jnp.where(_oh(p, _IOTA4[:, None]), s.player_xy,
                            jnp.full_like(s.player_xy, -(1 << 20))), axis=0)
    req, n_req, _ = _cells(s, pxy[None] + _DIR_DBL[1:])
    res = jnp.max(jnp.where(_IOTA3[None, :] == jnp.minimum(req, 2)[:, None],
                            resources[None, :], 0.0), axis=-1)
    filled = jnp.where(req >= 3, n_active > n_req,
                       res >= n_req.astype(_f32))
    return (req != 5) & filled


_MOVESHOP_W = _head_mask_w(MOVE0, 26)   # move (7) + shop (19) heads


def _obs_mask(m, phase, mv, shop_av):
    """cog_env::update_observation — move/shop heads of a stored mask
    (src/environment.cpp:252-279), packed words. After the NULL reset the
    non-index-0 move/shop bits are zero, so OR == replace."""
    m = (m & ~_MOVESHOP_W) | (_NULL_W & _MOVESHOP_W)
    m = m | jnp.where(phase == TurnPhase.MOVEMENT,
                      _pack_head_w(mv, MOVE0 + 1), jnp.int32(0))
    m = m | jnp.where(phase == TurnPhase.BUYING,
                      _pack_head_w(shop_av, SHOP0 + 1), jnp.int32(0))
    return m


def _update_observation(s: EnvState, agent):
    """Map-reading variant used on the reset path (positions are fresh)."""
    mv = _movement_mask(s, agent, s.resources,
                        _get1(s.n_active, agent, _IOTA4).astype(_i32))
    m = _obs_mask(_wrow(s.storage_masks, agent), s.phase,
                  mv, _shop_available(s, s.resources[2]))
    return s._replace(
        storage_masks=_put_row(s.storage_masks, agent, m))


# --------------------------------------------------------------------- reset
def _player_reset(s: EnvState, p):
    """Player::reset (src/player.cpp:29-43); `played` pile survives."""
    oh_p = _oh(p, _IOTA4)
    z21 = jnp.zeros(N_CARDTYPES, _u8)
    start_discard = (z21.at[CardType.EXPLORER].set(3)
                     .at[CardType.TRAVELER].set(4)
                     .at[CardType.SAILOR].set(1))
    new_p = jnp.stack([z21, z21, z21, _u8row(s.piles[:, PILE_PLAYED], p),
                       start_discard])
    piles = jnp.where(_oh(p, _IOTA4[:, None, None]), new_p[None], s.piles)
    z = jnp.zeros((), _u8)
    s = s._replace(
        has_won=jnp.where(oh_p, False, s.has_won),
        mip=jnp.where(oh_p, False, s.mip),
        next_card_free=jnp.where(oh_p, False, s.next_card_free),
        next_move_free=jnp.where(oh_p, False, s.next_move_free),
        n_removes=jnp.where(oh_p, z, s.n_removes),
        steps_taken=jnp.where(oh_p, z, s.steps_taken),
        n_movements=jnp.where(oh_p, 0, s.n_movements),
        n_added=jnp.where(oh_p, z, s.n_added),
        piles=piles,
        n_in_draw=jnp.where(oh_p, z, s.n_in_draw),
        n_in_hand=jnp.where(oh_p, z, s.n_in_hand),
        n_active=jnp.where(oh_p, z, s.n_active),
        sel_mask=_mask_reset_w(s.sel_mask))
    s = _deck_draw(s, p, jnp.asarray(HAND_SIZE, _i32))
    return s._replace(storage_masks=_put_row(
        s.storage_masks, p, s.sel_mask))


def _update_observation_ball(s: EnvState, agent, ball):
    """_update_observation against pregathered ball rows (req, nr, end),
    each (4, 19) — the gather-free form the reset queue uses. With no
    prior hop (m_eff = 0) _movement_mask_row probes exactly the six
    one-hop cells _movement_mask reads from the map."""
    req, nr, end = ball
    oh = _oh(agent, _IOTA4[:, None])
    row = (jnp.sum(jnp.where(oh, req, 0), axis=0),
           jnp.sum(jnp.where(oh, nr, 0), axis=0),
           jnp.sum(jnp.where(oh, end, 0), axis=0))
    mv = _movement_mask_row(row, jnp.asarray(0, _i32), s.resources,
                            _get1(s.n_active, agent, _IOTA4).astype(_i32))
    m = _obs_mask(_wrow(s.storage_masks, agent), s.phase,
                  mv, _shop_available(s, s.resources[2]))
    return s._replace(
        storage_masks=_put_row(s.storage_masks, agent, m))


def w3_words_from_cells(req, nr, end):
    """pack_ball_words' w3 for every player from pregathered (4, 19)
    ball rows (see w3_words_all)."""
    ids = cell_type_ids(req, nr, end)
    w3 = jnp.zeros_like(ids[:, 0])
    for i in range(6):
        w3 = w3 | (ids[:, 1 + i] << (5 * i))
    return w3 | (end[:, 0] << 30)                              # (4,)


def reset_body(s: EnvState, player_xy, ball) -> EnvState:
    """Everything in cog_env::reset AFTER map generation, with the map
    reads pregathered: ``player_xy`` (4, 2) already gated by
    add_players' bounds, ``ball`` the (req, nr, end) (4, 19) rows at
    those positions. While-free and gather-free; the reset queue vmaps
    it over its envs (vec._KernelPrograms). Touches only DYN fields."""
    s = s._replace(
        agent=jnp.asarray(0, _i32),
        phase=jnp.asarray(int(TurnPhase.INACTIVE), _i32))

    for p in range(MAX_N_PLAYERS):
        s = _select(p < s.n_players, _player_reset(s, p), s)

    s = s._replace(player_xy=player_xy)

    # Shop::reset (src/cards.cpp:94-100): n_in_market untouched
    s = s._replace(shop_stock=jnp.full(18, 3, _u8), in_market=_SHOP_MKT0,
                   done=jnp.bool_(False), turn_counter=jnp.asarray(0, _i32))

    for p in range(MAX_N_PLAYERS):
        s = _select(p < s.n_players,
                    _update_observation_ball(s, p, ball), s)
    return s._replace(
        sel_mask=_wrow(s.storage_masks, s.agent),
        w3_cache=w3_words_from_cells(*ball))


def reset_map_prelude(rng, n_pieces, difficulty, n_players):
    """Map generation + add_players gating + the ball pregather — the
    while-heavy / map-reading half of cog_env::reset. Returns
    (gen, player_xy, ball) for reset_body."""
    gen = generate_map(rng, n_pieces, difficulty)
    # add_players (src/map.cpp:343-354, oracle-patched bounds)
    gate = ((gen.player_start_no > 0)
            & (gen.player_start_no < n_players + 1)
            & (_IOTA4 < n_players))
    player_xy = jnp.where(gate[:, None], gen.player_start_xy, 0)
    ball = _ball_cells_xy(gen.ids, gen.min_xy, player_xy)
    return gen, player_xy, ball


def reset_env(s: EnvState) -> EnvState:
    """cog_env::reset (src/environment.cpp:42-64). Map generation consumes a
    copy of the engine; deck draws continue from the caller's stream."""
    gen, player_xy, ball = reset_map_prelude(s.rng, s.n_pieces,
                                             s.difficulty, s.n_players)
    s = s._replace(
        map_ids=gen.ids, min_xy=gen.min_xy,
        map_ok=gen.ok, map_overflow=gen.overflow)
    return reset_body(s, player_xy, ball)


def reset_env_full(s: EnvState, seed, n_players, n_pieces, difficulty,
                   max_steps) -> EnvState:
    """cog_env::reset(seed, ...) (src/environment.cpp:66-77)."""
    s = s._replace(rng=R.seed(seed),
                   n_players=jnp.asarray(n_players, _i32),
                   n_pieces=jnp.asarray(n_pieces, _i32),
                   difficulty=jnp.asarray(difficulty, _i32),
                   max_steps=jnp.asarray(max_steps, _i32))
    return reset_env(s)


# ---------------------------------------------------------------------- step
def _end_turn_p(v: PView):
    """Player::end_turn (src/player.cpp:170-180). Returns (view, saved)
    where ``saved`` is the post-redraw selected mask written into the
    player's storage row."""
    actpl = _wrap8(v.active + v.played)
    z21 = jnp.zeros(N_CARDTYPES, _u8)
    v = v._replace(discard=_wrap8(v.discard + actpl),
                   active=z21, played=z21,
                   n_active=jnp.zeros((), _u8))
    n_draw = HAND_SIZE - v.n_in_hand
    v = _select(n_draw > 0, _deck_draw_p(v, jnp.maximum(n_draw, 0)), v)
    return v._replace(resources=jnp.zeros(3, _f32)), v.sel


def _run_special_p(v: PView, special, ball_p) -> PView:
    """Card special actions (src/cards.cpp:8-36) + the shop-disable
    continuation (src/environment.cpp:156-159). Runs on the current agent's
    view; ``v.storage`` must hold the post-update_observation mask (the
    reference executes specials after update_observation, and a pending
    special implies the turn did not rotate)."""

    SHOP1_W = _head_mask_w(SHOP0 + 1, 18)
    MOVE_W = _head_mask_w(MOVE0, 7)

    def put_shop(m, v):
        return (m & ~SHOP1_W) | _pack_head_w(
            _shop_avail(v.shop_stock, v.in_market, v.n_in_market,
                        jnp.asarray(0.0, _f32)), SHOP0 + 1)

    def f_transmit(v):
        m = (v.storage & ~MOVE_W) | (_NULL_W & MOVE_W)
        m = (m & ~SHOP1_W) | _pack_head_w(v.shop_stock > 0, SHOP0 + 1)
        v = _disable_playing_p(v._replace(storage=m))
        return v._replace(next_card_free=jnp.bool_(True))

    # one shared _deck_draw instance serves all four draw specials: the
    # live-gated RNG (uniform_int_fast_maybe) consumes the stream only for
    # k < nd, so a traced draw count reproduces each branch's stream exactly
    nd = jnp.where(special == T.SPECIAL_DRAW3, 3,
                   jnp.where(special == T.SPECIAL_DRAW1_REMOVE1, 1,
                             jnp.where((special == T.SPECIAL_DRAW2)
                                       | (special == T.SPECIAL_DRAW2_REMOVE2),
                                       2, 0)))
    sd = _deck_draw_p(v, nd)

    def f_draw_remove(v):
        # remove head := play head incl. index 0 (src/cards.cpp:18), as
        # pure word algebra: REMOVE0 = 44 puts play bits 0..19 at w1
        # bits 12..31 and play bits 20..21 at w2 bits 0..1
        w0 = v.storage[0]
        w1 = ((v.storage[1] & 0xFFF)
              | jax.lax.shift_left(w0 & 0xFFFFF, np.int32(12)))
        w2 = ((v.storage[2] & ~jnp.int32(3))
              | (jax.lax.shift_right_logical(w0, np.int32(20)) & 3))
        m = jnp.stack([w0, w1, w2])
        m = put_shop(m, v)
        v = _disable_playing_p(v._replace(storage=m))
        return v._replace(n_removes=nd.astype(_u8))

    def f_native(v):
        mv = _movement_mask_row(ball_p, jnp.asarray(0, _i32),
                                jnp.full(3, 100.0, _f32),
                                jnp.asarray(100, _i32))
        m = ((v.storage & ~_head_mask_w(MOVE0 + 1, 6))
             | _pack_head_w(mv, MOVE0 + 1))
        m = put_shop(m, v)
        v = _disable_playing_p(v._replace(storage=m))
        return v._replace(next_move_free=jnp.bool_(True))

    def f_shop_disable(v):
        return v._replace(storage=put_shop(v.storage, v))

    out = _select(special == T.SPECIAL_TRANSMIT, f_transmit(v), v)
    out = _select((special == T.SPECIAL_DRAW2)
                  | (special == T.SPECIAL_DRAW3), sd, out)
    out = _select((special == T.SPECIAL_DRAW1_REMOVE1)
                  | (special == T.SPECIAL_DRAW2_REMOVE2),
                  f_draw_remove(sd), out)
    out = _select(special == T.SPECIAL_NATIVE, f_native(v), out)
    out = _select(special == T.SPECIAL_SHOP_DISABLE, f_shop_disable(v), out)
    return out


def step_env(s: EnvState, action) -> EnvState:
    """cog_env::step (src/environment.cpp:91-224). ``action``: i32[5]
    (play, play_special, remove, move, get_from_shop); dead steps (done
    envs) are no-ops."""
    return step_core(s, action, ball_words(s))


def _step_pre(s: EnvState, p) -> EnvState:
    """steps_taken/info bookkeeping + INACTIVE->MOVEMENT phase entry
    (src/environment.cpp:97-98,226-231)."""
    oh_p = _oh(p, _IOTA4)
    one8 = jnp.asarray(1, _u8)
    return s._replace(
        info_steps=_wrap8(s.info_steps + jnp.where(oh_p, one8,
                                                   jnp.zeros((), _u8))),
        phase=jnp.where(s.phase == TurnPhase.INACTIVE,
                        jnp.asarray(int(TurnPhase.MOVEMENT), _i32), s.phase),
        steps_taken=_wrap8(s.steps_taken + jnp.where(oh_p, one8,
                                                     jnp.zeros((), _u8))))


def step_core(s: EnvState, action, ball) -> EnvState:
    """The map-free step body: all map reads come from the pregathered
    ``ball`` — the 4 packed i32 words of ball_words (current agent's
    2-hop ball + next agent's 1-hop cells as 5-bit cell-type ids).
    Shared verbatim by step_env and the blocked rollout scan
    (vec._KernelPrograms, through fused_sample_step).

    Structure: project the current player ONCE (PView), run the whole
    dispatch (src/environment.cpp:91-224) on the projected values, embed
    back in a single pass, then apply the episode-end logic on the full
    state."""
    p = s.agent
    s1 = _step_pre(s, p)
    return _step_from_view(s, s1, _pview(s1, p), p, action, ball)


def fused_sample_step(s: EnvState, srng, ball, mask_src: str = "storage",
                      gate_dead: bool = False):
    """Sampler + step sharing ONE player projection: the sampler reads the
    current player's stored mask straight off the view instead of a second
    (4,92) gather. Returns (state', srng', action).

    ``gate_dead=True`` freezes a done env's sampler stream (no draws are
    consumed on dead steps). The reference's vec envs are never done at
    sample time (auto-reset happens inside step_single,
    include/vec_environment.h:53-61), so a frozen env's stream position at
    revival equals the reference's position at its episode boundary —
    per-env trajectories with dead steps excluded are then bit-exact
    against the reference's continuous same-step-auto-reset sequences
    (the deferred-reset "exact" mode, vec.rollout_chunked(exact=True))."""
    p = s.agent
    s1 = _step_pre(s, p)
    v = _pview(s1, p)
    mask = v.storage if mask_src == "storage" else s.sel_mask
    live = ~s.done if gate_dead else None
    action, srng, tainted = _sample_action_w(srng, mask, live)
    s2 = _step_from_view(s, s1, v, p, action, ball)
    s2 = s2._replace(rng_tainted=s2.rng_tainted | tainted)
    return s2, srng, action


def _step_from_view(s0: EnvState, s: EnvState, v: "PView", p, action,
                    ball) -> EnvState:
    action = jnp.asarray(action, _i32)
    a_play, a_sp, a_rm, a_mv, a_shop = (action[i] for i in range(5))
    one8 = jnp.asarray(1, _u8)
    w0, w1, w2, w3p = ball
    ball_p = _decode_cells(_ball_p_ids(w0, w1, w2))
    # refresh the agent's cached one-hop word (their current position's
    # row, pregathered), then read the next agent's from the cache —
    # fresh by construction: a row only goes stale when its player moves,
    # and a mover's row is refreshed at their next action step before any
    # read (rotation away from a mover only happens on a winning step,
    # which ends the episode). q == p (1-player) reads the fresh row.
    w3_cache = jnp.where(_oh(p, _IOTA4), w3p, s.w3_cache)

    b_play = a_play > 0
    b_special = (a_play == 0) & (a_sp > 0)
    b_move = (a_play == 0) & (a_sp == 0) & (a_mv > 0)
    b_else = (a_play == 0) & (a_sp == 0) & (a_mv == 0)
    b_shop = b_else & (a_shop > 0)
    b_remove = b_else & (a_shop == 0) & (a_rm > 0)
    b_null = b_else & (a_shop == 0) & (a_rm == 0)

    # ---- play branch (src/environment.cpp:104-108, src/player.cpp:47-69)
    def f_play(v):
        idx = jnp.clip(a_play - 1, 0, N_CARDTYPES - 1)
        # per-channel masked maxes of the card's resource row
        oh_c = _oh(idx, _IOTA21)
        res_mov = jnp.stack([
            jnp.max(jnp.where(oh_c, _CARD_RES[:, c], 0.0))
            for c in range(3)])
        coin = res_mov[2]
        res_buy = v.resources + jnp.where(
            _IOTA3 == 2, jnp.where(coin > 0, coin, jnp.asarray(0.5, _f32)),
            0.0)
        res = jnp.where(v.phase == TurnPhase.MOVEMENT, res_mov,
                        jnp.where(v.phase == TurnPhase.BUYING, res_buy,
                                  v.resources))
        return _activate_p(v._replace(resources=res), idx)

    # ---- play_special branch (src/environment.cpp:110-112)
    def f_special(v):
        idx = jnp.clip(a_sp - 1, 0, N_CARDTYPES - 1)
        return _select(_get1(_CARD_SINGLE, idx, _IOTA21),
                       _remove_immediate_p(v, idx),
                       _play_immediate_p(v, idx))

    # ---- move branch (src/environment.cpp:115-125)
    def f_move(v):
        dxy = jnp.max(jnp.where(_oh(a_mv, np.arange(7)[:, None]), _DIR_DBL,
                                jnp.full_like(_DIR_DBL, -(1 << 20))), axis=0)
        v = v._replace(xy=v.xy + dxy)
        kidx = jnp.max(jnp.where(_oh(a_mv, np.arange(7)), _PAIR[0],
                                 jnp.zeros_like(_PAIR[0])))
        req, n_req, is_end = _ball_at_p(ball_p, kidx)

        # flat merge of the move sub-branches (src/player.cpp:141-162):
        # free move / resource requirement / DISCARD-REMOVE hex
        p_free = v.next_move_free
        p_res = ~p_free & (req < 3)
        p_pick = ~p_free & ((req == 3) | (req == 4))

        # resource requirement (src/player.cpp:141-150)
        ridx = jnp.minimum(req, 2)
        oh_r = _oh(ridx, _IOTA3)
        left = jnp.where(
            ridx == 0, v.resources[0],
            jnp.where(ridx == 1, v.resources[1],
                      v.resources[2])) - n_req.astype(_f32)
        res = jnp.where(oh_r, left, 0.0)
        first = ~v.mip
        with_play = _play_last_activated_p(v)._replace(mip=jnp.bool_(True))
        res_state = _select(first, with_play, v)._replace(resources=res)
        # REMOVE / DISCARD hexes (src/player.cpp:151-158)
        pick_state = _pick_actives_p(v, n_req, req == 3)
        pick_state = pick_state._replace(
            resources=jnp.zeros(3, _f32), mip=jnp.bool_(False))
        free_state = _enable_playing_p(
            v._replace(next_move_free=jnp.bool_(False)))

        v = _merge(v, (p_free, free_state), (p_res, res_state),
                   (p_pick, pick_state))
        return v._replace(n_movements=v.n_movements + 1,
                          has_won=is_end > 0)

    # ---- else branches (src/environment.cpp:128-174): shop / remove /
    # null share the next_move_free teardown; each body reads the view
    # with it already cleared and the flat merge charges one scalar select
    def f_else_body(v):
        v = v._replace(next_move_free=jnp.bool_(False))

        def f_shop(v):
            i = jnp.clip(a_shop - 1, 0, N_BUYABLETYPES - 1)
            oh_i = _oh(i, _IOTA18)
            free = v.next_card_free
            in_mkt_i = _any1(v.in_market & oh_i)
            # buy: reopen slot before get (src/cards.cpp:102-106)
            n_mkt = _wrap8(v.n_in_market + jnp.where(
                free, 0, 1 - in_mkt_i.astype(_i32)))
            in_mkt = jnp.where(free, v.in_market, v.in_market | oh_i)
            # get (src/cards.cpp:136-142)
            stock = _wrap8(v.shop_stock - jnp.where(oh_i, one8,
                                                    jnp.zeros((), _u8)))
            stock_i = jnp.max(jnp.where(oh_i, stock, 0))
            close = (stock_i == 0) & _any1(in_mkt & oh_i)
            in_mkt = jnp.where(close, in_mkt & (_IOTA18 != i), in_mkt)
            n_mkt = jnp.where(close, _wrap8(n_mkt - one8), n_mkt)
            card = jnp.max(jnp.where(oh_i, _SHOP_TYPE, 0))
            cost = jnp.max(jnp.where(oh_i, _SHOP_COST, 0.0))
            res = jnp.where(free, v.resources,
                            v.resources - jnp.where(_IOTA3 == 2, cost, 0.0))
            # phase cycle: phase is always in {0,1,2}, so (p+1)%3 is a
            # compare-select (jnp's % emits a floor-mod chain of ~6 ops)
            phase = jnp.where(free, v.phase,
                              jnp.where(v.phase == 2, 0, v.phase + 1))
            oh_card = _oh(card, _IOTA21)
            return v._replace(
                shop_stock=stock, in_market=in_mkt, n_in_market=n_mkt,
                resources=res, phase=phase,
                discard=_wrap8(v.discard + jnp.where(oh_card, one8,
                                                     jnp.zeros((), _u8))),
                n_added=_wrap8(v.n_added + one8))

        def f_remove(v):
            idx = jnp.clip(a_rm - 1, 0, N_CARDTYPES - 1)
            v = _remove_immediate_p(v, idx)
            v = v._replace(n_removes=_wrap8(v.n_removes - one8))
            return _select(v.n_removes == 0, _enable_playing_p(v), v)

        def f_null(v):
            v = v._replace(phase=jnp.where(v.phase == 2, 0, v.phase + 1))
            pending = v.n_removes > 0
            cleared = _enable_playing_p(
                v._replace(n_removes=jnp.zeros((), _u8)))
            return _select(pending, cleared, v)

        return f_shop(v), f_remove(v), f_null(v)

    shop_v, remove_v, null_v = f_else_body(v)
    v = _merge(v, (b_play, f_play(v)), (b_special, f_special(v)),
               (b_move, f_move(v)), (b_shop, shop_v),
               (b_remove, remove_v), (b_null, null_v))
    # next_card_free tail (src/environment.cpp:170-173) — reachable only
    # via the else clause of the dispatch
    freed = _enable_playing_p(v._replace(next_card_free=jnp.bool_(False)))
    v = _select(b_else & v.next_card_free, freed, v)

    # pending special id (executed after update_observation)
    special = jnp.where(
        b_special,
        _get1(_CARD_SPECIAL, jnp.clip(a_sp - 1, 0, N_CARDTYPES - 1), _IOTA21),
        0)
    special = jnp.where(
        (a_play == 0) & (a_sp == 0) & (a_mv == 0) & (a_shop == 0)
        & (a_rm > 0) & (v.n_removes != 0),
        T.SPECIAL_SHOP_DISABLE, special)

    # movement_in_progress teardown (src/environment.cpp:176-179) — gated on
    # the *raw* action.move field, not the dispatched branch: a step that
    # plays a card while also carrying a nonzero move sub-action skips it.
    tear = v.mip & (a_mv == 0)
    v = _select(tear, v._replace(mip=jnp.bool_(False),
                                 resources=jnp.zeros(3, _f32)), v)

    # maybe_end_turn (src/environment.cpp:244-250): end_turn + rotation.
    # The saved mask is the post-redraw sel; the next agent's sel restores
    # from their stored mask (or the just-saved one for a 1-player game).
    rotate = v.has_won | (v.phase == TurnPhase.INACTIVE)
    et_v, saved = _end_turn_p(v)
    q = p + 1
    q = jnp.where(q >= s.n_players, 0, q)
    row_q = _wrow(s.storage_masks, q)
    sel_next = jnp.where(q == p, saved, row_q)
    v = _select(rotate, et_v._replace(sel=sel_next), v)

    # update_observation for the post-rotation agent r (= q if rotated,
    # else p): rebuild the move/shop heads of r's stored mask
    # (src/environment.cpp:252-279)
    rot_other = rotate & (q != p)
    storage_r = jnp.where(rotate, saved, v.storage)
    storage_r = jnp.where(rot_other, row_q, storage_r)
    n_active_r = jnp.where(rot_other, _get1(s.n_active, q, _IOTA4),
                           v.n_active)
    ball_q = _ball_q_row(jnp.sum(jnp.where(_oh(q, _IOTA4), w3_cache, 0)))
    ball_r = jax.tree_util.tree_map(
        lambda a, b: jnp.where(rotate, b, a), ball_p, ball_q)
    # position delta for the current agent within this step: only a
    # non-rotated mover has hopped relative to the pregathered ball
    m_eff = jnp.where(b_move & ~rotate, a_mv, 0)
    mv_mask = _movement_mask_row(ball_r, m_eff, v.resources, n_active_r)
    new_mask_r = _obs_mask(storage_r, v.phase, mv_mask,
                           _shop_avail(v.shop_stock, v.in_market,
                                       v.n_in_market, v.resources[2]))

    # special function (src/environment.cpp:183-186): a pending special
    # implies the turn did not rotate, so the target row is p and its
    # current value is new_mask_r
    v = v._replace(storage=new_mask_r)
    v = _select(special > 0, _run_special_p(v, special, ball_p), v)

    # ---- single-pass write-back
    mask_p_final = jnp.where(rotate, saved, v.storage)
    mask_r_final = jnp.where(rotate, new_mask_r, v.storage)
    r_idx = jnp.where(rotate, q, p)
    s = _pview_embed(s, p, v._replace(storage=mask_p_final))
    s = s._replace(
        storage_masks=_put_row(s.storage_masks, r_idx, mask_r_final),
        agent=r_idx,
        turn_counter=s.turn_counter + rotate.astype(_i32),
        w3_cache=w3_cache)

    # done check (src/environment.cpp:187-207)
    k0 = jnp.max(jnp.where(_oh(m_eff, np.arange(7)), _PAIR[:, 0], 0))
    _, _, on_end = _ball_at_p(ball_r, k0)
    end_now = (special == 0) & ((on_end > 0)
                                | (s.turn_counter >= s.max_steps))
    n_winners = jnp.sum(s.has_won.astype(_f32))
    live = _IOTA4 < s.n_players
    returns = (s.n_players.astype(_f32) * s.has_won.astype(_f32)
               - n_winners)
    finished = s._replace(
        done=jnp.bool_(True),
        info_total=s.turn_counter,
        info_steps=jnp.where(live, s.steps_taken, s.info_steps),
        info_returns=jnp.where(live, returns, s.info_returns),
        rewards=jnp.where(live, returns, s.rewards),
        info_travelled=jnp.where(live, s.n_movements, s.info_travelled),
        info_added=jnp.where(live, s.n_added, s.info_added),
        info_removed=jnp.where(live, s.n_added, s.info_removed),
        info_card_uses=jnp.where(live, s.n_added.astype(_i32),
                                 s.info_card_uses))
    s = _select(end_now, finished, s)
    return _select(s0.done, s0, s)


# Fields the step never writes (static across steps; only reset touches
# them). vec.py keeps these out of the lax.scan carry; the blocked step
# never receives them at all (map reads are pregathered ball cells).
STATIC_FIELDS = ("map_ids", "min_xy", "map_ok", "map_overflow",
                 "n_players", "n_pieces",
                 "difficulty", "max_steps")
DYN_FIELDS = tuple(f for f in EnvState._fields if f not in STATIC_FIELDS)


def split_state(states):
    return (tuple(getattr(states, f) for f in STATIC_FIELDS),
            tuple(getattr(states, f) for f in DYN_FIELDS))


def merge_state(static, dyn):
    parts = dict(zip(STATIC_FIELDS, static))
    parts.update(zip(DYN_FIELDS, dyn))
    return EnvState(**parts)


# ------------------------------------------------------------------- sampler
_HEAD_DEFS = ((PLAY0, 22), (SPECIAL0, 22), (REMOVE0, 22),
              (MOVE0, 7), (SHOP0, 19))


def _sample_action_w(rng, w, live=None):
    """sample_action on a packed (3,)-word mask (the step-internal form)."""
    outs = []
    tainted = jnp.bool_(False)
    for off, width in _HEAD_DEFS:
        f = _head_field_w(w, off, width)               # scalar, bits 0..21
        bits = (f >> np.arange(width)) & 1             # (width,) i32
        n = jnp.sum(bits)
        if live is None:
            pos, rng, tt = R.uniform_int_fast(rng, jnp.maximum(n, 1))
        else:
            pos, rng, tt = R.uniform_int_fast_maybe(
                rng, jnp.maximum(n, 1), live)
        tainted = tainted | tt
        csum = _csum_incl(bits) - bits
        # exactly one position matches; sum-of-index replaces bool argmax
        match = (bits == 1) & (csum == pos.astype(_i32))
        val = jnp.sum(jnp.where(match, np.arange(width), 0), dtype=_i32)
        outs.append(jnp.where(n > 0, val, 0))
    return jnp.stack(outs), rng, tainted


def sample_action(rng, mask, live=None):
    """action_sampler::sample (include/sampler.h:14-79): per head, a uniform
    pick over the valid indices (all five heads always contain index 0, so
    exactly five engine draws are consumed). Returns (action5, rng, tainted)
    with ``tainted`` flagging the once-per-1e16-draws double-rejection
    deviation from the exact libstdc++ stream.

    ``mask`` is the flat (92,) bool mask (reference ABI); the fused step
    paths use the packed-word form directly (_sample_action_w).
    ``live`` (optional bool) gates the engine draws: when False no stream
    is consumed at all (used to freeze finished envs in the deferred
    exact-auto-reset mode; see fused_sample_step)."""
    return _sample_action_w(rng, pack_mask(mask), live)
