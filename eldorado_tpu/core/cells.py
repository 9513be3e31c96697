"""Canonical cell-type encoding: the 5-bit id plane IS the map state.

The obs raster only ever contains hexes from the fixed piece library
(reference: src/map.cpp:113-152 terrain prototypes): 18 distinct
(requirement, n_required, is_end) triples, plus the empty/sentinel cell
(5, 0, 0).  Every filled cell with requirement < 5 has n_required >= 1
(verified at import below), so the reference's (48, 48, 7) u8 channel
observation (include/api.h:84-129) round-trips LOSSLESSLY through the
id plane — which is therefore the engine's canonical map representation:

* `EnvState.map_ids` holds one flat (2304,) i32 id per grid cell.
* The hot paths (per-step ball reads, the tile-packed ball-word table,
  reset-queue map shipping) consume ids directly — no narrow-minor-7
  channel layout ever materialises on device; reset events ship
  (Q, 2304) i32 id planes.
* `expand_obs` produces the reference-ABI channel layout at COLD
  boundaries only (compat bindings, golden comparisons, rendering) —
  mirroring the reference, where finalize's rasterisation is reset-time
  work and the per-step cost is zero (src/map.cpp:389-405).

5-bit type ids (sentinel = id 0, so zero padding reads as sentinel) let
a player's whole 19-cell ball ride in three i32 words — the step's map
read shrinks to 4 gathered words/env.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import GRIDSIZE
from . import tables as T

_i32 = jnp.int32
_u8 = jnp.uint8

_CELL_TRIPLES = [(5, 0, 0)] + sorted(
    {tuple(int(x) for x in h[:3])
     for h in T.PIECE_HEX[T.PIECE_HEX_VALID.astype(bool)]} - {(5, 0, 0)})
N_CELL_TYPES = len(_CELL_TRIPLES)
assert N_CELL_TYPES <= 32, _CELL_TRIPLES
# Lossless-roundtrip invariant: a requirement channel value of 0 in the
# reference obs layout means "no requirement" — a (req < 5, n_req == 0)
# hex would be indistinguishable from an empty cell after expansion.
assert not any(t[0] < 5 and t[1] == 0 for t in _CELL_TRIPLES), _CELL_TRIPLES
# decode LUTs bit-packed into scalar ints: variable-shift extraction
# instead of a (19,)-table gather
_REQ_L0 = sum(_CELL_TRIPLES[i][0] << (3 * i) for i in range(10))
_REQ_L1 = sum(_CELL_TRIPLES[i][0] << (3 * (i - 10))
              for i in range(10, N_CELL_TYPES))
_NR_L0 = sum(_CELL_TRIPLES[i][1] << (3 * i) for i in range(10))
_NR_L1 = sum(_CELL_TRIPLES[i][1] << (3 * (i - 10))
             for i in range(10, N_CELL_TYPES))
_END_L = sum(_CELL_TRIPLES[i][2] << i for i in range(N_CELL_TYPES))


def cell_type_ids(req, nr, end):
    """(req, n_req, is_end) -> 5-bit cell-type id, elementwise. A
    compare-select chain, NOT a LUT gather, so the (n, 2304)-cell table
    build stays elementwise."""
    key = (req << 4) | (nr << 1) | end
    out = jnp.zeros_like(key)
    for i, (r, n, e) in enumerate(_CELL_TRIPLES[1:], start=1):
        out = jnp.where(key == ((r << 4) | (n << 1) | e), i, out)
    return out


def decode_cells(ids):
    """5-bit type ids -> (req, n_req, is_end), any shape. Pure shift/mask
    arithmetic against bit-packed scalar LUTs — no gather."""
    lo = ids < 10
    s3 = 3 * jnp.where(lo, ids, ids - 10)
    req = jnp.where(lo, _REQ_L0 >> s3, _REQ_L1 >> s3) & 7
    nr = jnp.where(lo, _NR_L0 >> s3, _NR_L1 >> s3) & 7
    return req, nr, (_END_L >> ids) & 1


def expand_obs(ids):
    """Flat (2304,) id plane -> the reference-ABI (48, 48, 7) u8 map
    observation (include/api.h:84-129 ObsData.shared.map; rasterised in
    src/map.cpp:389-405): channel req+1 holds n_required for requirement
    cells, channel 6 holds is_end.  COLD-boundary helper (compat
    bindings, goldens, render) — the hot paths never build this layout.
    Single plane; vmap for batches."""
    ids = jnp.asarray(ids).reshape(GRIDSIZE * GRIDSIZE)
    req, nr, end = decode_cells(ids.astype(_i32))
    ch = jnp.where(req < 5, req + 1, 0)
    chval = jnp.where(req < 5, nr, 0)
    iota7 = jnp.arange(7, dtype=_i32)
    cellch = jnp.where(iota7[None, :] == ch[:, None], chval[:, None], 0)
    cellch = jnp.where(iota7[None, :] == 6, end[:, None], cellch)
    return cellch.astype(_u8).reshape(GRIDSIZE, GRIDSIZE, 7)


def ids_from_obs(obs):
    """Reference-ABI (..., 48, 48, 7) map observation -> flat (..., 2304)
    i32 id plane (the exact inverse of `expand_obs` — lossless by the
    triple-set invariant asserted above). Boundary/test helper."""
    cell = jnp.asarray(obs).astype(_i32)
    reqch = cell[..., 1:6]
    present = reqch > 0
    req = jnp.where(jnp.any(present, -1), jnp.argmax(present, -1), 5)
    nr = jnp.max(jnp.where(present, reqch, 0), -1)
    ids = cell_type_ids(req, nr, cell[..., 6])
    return ids.reshape(ids.shape[:-2] + (GRIDSIZE * GRIDSIZE,))


def expand_obs_np(ids):
    """Numpy `expand_obs` for host-side cold paths (compat snapshots)."""
    ids = np.asarray(ids).reshape(-1, GRIDSIZE * GRIDSIZE).astype(np.int64)
    trip = np.asarray(_CELL_TRIPLES, np.int64)          # (NT, 3)
    req, nr, end = trip[ids, 0], trip[ids, 1], trip[ids, 2]
    out = np.zeros(ids.shape + (7,), np.uint8)
    filled = req < 5
    np.put_along_axis(out, np.where(filled, req + 1, 0)[..., None],
                      np.where(filled, nr, 0)[..., None].astype(np.uint8),
                      axis=-1)
    out[..., 6] = end
    return out.reshape(out.shape[0], GRIDSIZE, GRIDSIZE, 7)
