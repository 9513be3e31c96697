"""The blocked rollout step == the env-major vmapped step, bit for bit.

``vec._KernelPrograms`` scans ``vec._blocked_step`` over a carry laid out
(n // block, f..., block) with bools held as i32. Driving it for a few
steps through ``kernel_rollout`` must reproduce the plain
sample + step_env path exactly: actions, every EnvState leaf and the
sampler streams, for both mask sources and for one block against two.
"""
import functools

import jax
import numpy as np
import pytest

from eldorado_tpu import vec
from eldorado_tpu.core import engine as E
from eldorado_tpu.vec import _active_mask, sampler_init, vec_reset


@functools.partial(jax.jit, static_argnums=(2, 3))
def xla_steps(s, r, mask_src, n_steps):
    def body(carry, _):
        s, r = carry
        a, r, t = jax.vmap(E.sample_action)(r, _active_mask(s, mask_src))
        s = jax.vmap(E.step_env)(s, a)
        return (s._replace(rng_tainted=s.rng_tainted | t), r), a
    (s, r), acts = jax.lax.scan(body, (s, r), None, length=n_steps)
    return s, r, acts


def _assert_same(a, b):
    (s1, r1, a1), (s2, r2, a2) = a, b
    assert np.array_equal(np.asarray(a1), np.asarray(a2)), "actions"
    assert np.array_equal(np.asarray(r1), np.asarray(r2)), "sampler rngs"
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(s1, name)),
                              np.asarray(getattr(s2, name))), name


def _blocked(states, srngs, T, mask_src, block):
    s, r, (acts, _, _, _) = vec.kernel_rollout(states, srngs, T, mask_src,
                                               block)
    return s, r, acts


@pytest.mark.parametrize("mask_src", ["storage", "sel"])
def test_kernel_matches_xla(mask_src):
    """One block: the blocked scan == the env-major vmapped step."""
    states = vec_reset(3, 8, 4, 1, 0, 100000)
    srngs = sampler_init(7, 8)
    _assert_same(_blocked(states, srngs, 10, mask_src, 8),
                 xla_steps(states, srngs, mask_src, 10))


def test_kernel_block_partitioning():
    """Two blocks produce the same result as one block and as the
    env-major vmapped step."""
    states = vec_reset(11, 16, 2, 3, 1, 100000)
    srngs = sampler_init(5, 16)
    two = _blocked(states, srngs, 10, "storage", 8)
    _assert_same(two, _blocked(states, srngs, 10, "storage", 16))
    _assert_same(two, xla_steps(states, srngs, "storage", 10))


def test_blocked_layout_roundtrip():
    """t_in/t_out invert each other for scalar and feature leaves, and env
    e sits in block e // block at lane e % block."""
    n, block = 12, 4
    t_in, t_out = vec._blocked_layout(n, block)
    x = np.arange(n * 6).reshape(n, 2, 3)
    bx = np.asarray(t_in(x))
    assert bx.shape == (3, 2, 3, 4)
    assert np.array_equal(bx[1, :, :, 2], x[1 * block + 2])
    assert np.array_equal(np.asarray(t_out(bx, (2, 3))), x)
    y = np.arange(n)
    assert np.asarray(t_in(y)).shape == (3, 1, 4)
    assert np.array_equal(np.asarray(t_out(t_in(y), ())), y)
