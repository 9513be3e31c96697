"""chip_smoke.py's phases, on the CPU at a few envs and on the card at
full width.

The CPU cases shrink every phase to 8-16 envs and short games so that
resets fire; they check the smoke test's own logic (the comparisons it
makes, the checksum it folds on the device) and the paths it drives.
The ``gpu`` cases run the phases as ``python chip_smoke.py`` does, and
skip where JAX has no GPU.
"""
import importlib.util
import os

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SMALL = {
    "parity": lambda: smoke.parity(limit=120),
    "main_path": lambda: smoke.main_path(n=8, chunk=50, chunks=4, block=8,
                                         max_steps=30),
    "exact_mode": lambda: smoke.exact_mode(n=8, chunk=50, chunks=4, block=8,
                                           slice_n=8),
    "learner_feeds": lambda: smoke.learner_feeds(
        n=8, chunk=40, chunks=3, block=8, full_chunk=20, spp=20),
    "async_resets": lambda: smoke.async_resets(n=8, chunk=50, chunks=4,
                                               block=8, max_steps=30),
    "sharded_path": lambda: smoke.sharded_path(
        n_per=8, chunk=50, chunks=4, block=8, runner_steps=40,
        max_steps=30),
}


@pytest.mark.parametrize("phase", sorted(SMALL))
def test_phase_small(phase):
    SMALL[phase]()


def test_device_check_refuses_cpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(smoke.SmokeFailure, match="no GPU"):
        smoke.device_check()


def test_checksum_matches_ring_consumer():
    """The device xor fold and RingConsumer's int64 checksum agree on the
    same records, blocked and env-major."""
    import numpy as np

    rng = np.random.default_rng(3)
    T, nb, block = 3, 2, 4
    traj = rng.integers(-2**31, 2**31, (T, nb, 5, block), dtype=np.int64)
    traj = traj.astype(np.int32)
    fold, init = smoke._xor_fold()
    _, lo, hi = fold(init, jax.numpy.asarray(traj))
    env_major = np.moveaxis(traj, -1, 2).reshape(T, nb * block, 5)
    flat = env_major.reshape(-1)
    want = np.bitwise_xor.reduce(flat.view(np.int64))
    assert smoke._checksum(lo, hi) == int(want)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["parity", "main_path", "exact_mode",
                                   "learner_feeds", "async_resets"])
def test_phase_on_gpu(phase):
    smoke.device_check()
    getattr(smoke, phase)()
