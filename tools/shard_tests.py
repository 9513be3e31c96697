#!/usr/bin/env python3
"""Deterministic test-file sharding for parallel CI lanes.

    python tools/shard_tests.py <shard> <n_shards>

Prints the shard's test files (space-separated). Files are weighted by
measured heaviness (golden replays and parallel/shard_map suites
dominate) and assigned greedily so the two CI lanes finish together;
every test file is in exactly one shard.
"""
import pathlib
import sys

# rough relative wall-clock weights (CPU lane, cold cache)
WEIGHTS = {
    "test_parallel.py": 10,
    "test_jax_parity.py": 8,
    "test_api_surfaces.py": 8,
    "test_step_kernel.py": 3,
    "test_chip_smoke.py": 8,
    "test_exact_reset.py": 5,
    "test_docs.py": 5,
    "test_ref_traj.py": 4,
    "test_bootstrap.py": 4,
    "test_stream.py": 3,
    "test_ref_mapgen.py": 3,
    "test_ball_words.py": 2,
    "test_rng_parity.py": 2,
    "test_map_capacity.py": 2,
    "test_map_failure.py": 2,
    "test_benchmarks.py": 2,
    "test_tables.py": 1,
}


def shards(n_shards):
    root = pathlib.Path(__file__).resolve().parent.parent / "tests"
    files = sorted(p.name for p in root.glob("test_*.py"))
    loads = [0] * n_shards
    out = [[] for _ in range(n_shards)]
    for name in sorted(files, key=lambda f: -WEIGHTS.get(f, 3)):
        i = loads.index(min(loads))
        loads[i] += WEIGHTS.get(name, 3)
        out[i].append(f"tests/{name}")
    return [sorted(s) for s in out]


def main():
    shard, n_shards = int(sys.argv[1]), int(sys.argv[2])
    print(" ".join(shards(n_shards)[shard]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
