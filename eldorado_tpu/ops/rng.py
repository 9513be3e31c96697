"""Bit-exact libstdc++ RNG kernels in pure int32 JAX ops.

The reference engine consumes ``std::default_random_engine`` (libstdc++ =
``minstd_rand0``: x' = 16807*x mod 2^31-1) through
``std::uniform_int_distribution<size_t>`` (libstdc++ "downscaling" rejection
algorithm) for every random decision: map generation, deck draws,
discard/remove picks, and the built-in action sampler (reference:
src/environment.cpp:18-22, src/cards.cpp:190, src/player.cpp:92,115,
include/sampler.h:25). Reproducing those streams exactly is the foundation of
trajectory parity, so the engine state is a single int32 per stream and every
kernel here is jit/vmap-friendly: all arithmetic is int32 with logical
shifts standing in for the unsigned operations (every held value fits in
[0, 2^31-1]; the one transient that can exceed it wraps mod 2^32 exactly as
the uint32 original did).

Derivation notes
----------------
* minstd_rand0 state lies in [1, M-1], M = 2^31-1 (prime). The 46-bit product
  16807*x is reduced with 16-bit splitting and the Mersenne-prime fold
  (2^31 === 1 mod M).
* libstdc++ uniform_int_distribution<T>(0, n-1) over an engine with range
  [1, 2^31-2] takes the "downscaling" branch whenever n <= 2147483645:
      scaling = 2147483645 / n;  past = n * scaling
      do r = engine() - 1 while r >= past
      return r / scaling
* ``uniform_int`` runs the rejection loop exactly (lax.while_loop);
  ``uniform_int_fast`` unrolls two attempts branchlessly for the hot path
  (P(two rejections) < 1.2e-16 per draw) and reports the would-be deviation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

M = 2147483647  # 2^31 - 1, minstd modulus
A = 16807
URNG_RANGE = 2147483645  # engine max-min = (M-1) - 1

_i32 = jnp.int32


def _shr(x, n):
    """Logical right shift on int32 (the unsigned >> of the original)."""
    return jax.lax.shift_right_logical(x, jnp.asarray(n, _i32))


def _div(a, b):
    """Truncating unsigned division: every quotient in these kernels has
    nonnegative operands, where lax.div == C++ '/'. jnp's // emits the
    floor-division correction chain (div+rem+sign+selects, ~5 ops per
    site) for a case that cannot occur."""
    return jax.lax.div(a, b)


def seed(s):
    """libstdc++ linear_congruential_engine::seed: x = s % M, 0 -> 1.

    Accepts uint32-valued input (as uint32 or int32 bit pattern)."""
    s = jnp.asarray(s, jnp.uint32)
    s = jnp.where(s >= M, s - M, s)
    s = jnp.where(s >= M, s - M, s)  # u32 max = 2M+1, two folds suffice
    s = jnp.where(s == 0, jnp.asarray(1, jnp.uint32), s)
    return s.astype(_i32)


def next_u31(x):
    """One minstd_rand0 step: x' = 16807*x mod (2^31-1), int32 arithmetic.

    x in [1, M-1] so all named quantities are nonnegative; ``y`` may wrap
    past 2^31 (int32 wraparound == the uint32 original's bits), which the
    logical shifts handle."""
    x = jnp.asarray(x, _i32)
    lo = A * (x & 0xFFFF)                   # 16807*65535 < 2^31
    hi = A * _shr(x, 16)                    # < 2^30
    y = lo + ((hi & 0x7FFF) << 16) + _shr(hi, 15)   # mod 2^32
    y = (y & 0x7FFFFFFF) + _shr(y, 31)
    return jnp.where(y >= M, y - M, y)


def uniform_int(x, uerange):
    """Exact libstdc++ uniform_int_distribution(0, uerange-1)(engine).

    Args:
      x: engine state (int32 scalar, in [1, M-1]).
      uerange: number of outcomes (traced int32 scalar, 1 <= n <= 2147483645).

    Returns:
      (value, new_state): value in [0, uerange-1], int32.
    """
    uerange = jnp.asarray(uerange, _i32)
    scaling = _div(jnp.asarray(URNG_RANGE, _i32), uerange)
    past = uerange * scaling

    def cond(carry):
        _, r = carry
        return r >= past

    def body(carry):
        xx, _ = carry
        xx = next_u31(xx)
        return xx, xx - 1

    x0 = next_u31(x)
    x, r = jax.lax.while_loop(cond, body, (x0, x0 - 1))
    return _div(r, scaling), x


def uniform_int_maybe(x, uerange, do_draw):
    """uniform_int that leaves the stream untouched when ``do_draw`` is False.

    Used for data-dependent draw counts (deck refills, discard/remove picks)
    where the reference consumes engine values only on executed iterations.
    """
    v, x_new = uniform_int(x, jnp.maximum(uerange, 1))
    x_out = jnp.where(do_draw, x_new, x)
    v_out = jnp.where(do_draw, v, jnp.asarray(0, _i32))
    return v_out, x_out


def uniform_int_fast(x, uerange):
    """Loop-free uniform_int: two unrolled rejection attempts.

    The downscaling rejection fires with probability < uerange / 2^31
    (< 1.1e-8 for every draw this engine makes, uerange <= 256); two
    consecutive rejections (< 1.2e-16) are beyond any realistic run length.
    Returns (value, new_state, tainted): ``tainted`` flags the
    double-rejection case where the value deviates from the exact stream —
    callers accumulate it so parity claims stay honest.
    """
    uerange = jnp.asarray(uerange, _i32)
    scaling = _div(jnp.asarray(URNG_RANGE, _i32), uerange)
    past = uerange * scaling
    x1 = next_u31(x)
    r1 = x1 - 1
    ok1 = r1 < past
    x2 = next_u31(x1)
    r2 = x2 - 1
    v = _div(jnp.where(ok1, r1, r2), scaling)
    x_out = jnp.where(ok1, x1, x2)
    tainted = (r1 >= past) & (r2 >= past)
    return v, x_out, tainted


def uniform_int_fast_maybe(x, uerange, do_draw):
    """uniform_int_fast that leaves the stream untouched when not drawing."""
    v, x_new, tainted = uniform_int_fast(x, jnp.maximum(uerange, 1))
    return (jnp.where(do_draw, v, jnp.asarray(0, _i32)),
            jnp.where(do_draw, x_new, x),
            do_draw & tainted)
