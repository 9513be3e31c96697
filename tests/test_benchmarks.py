"""Smoke tests for the perf/infra parity pieces: the asv benchmark
classes (reference: benchmarks/benchmarks.py asv grid + tracked
dashboard), and the buildable docs target (reference: Sphinx +
readthedocs). Neither asv nor Sphinx exists in this environment, so
these prove the interfaces work: asv-convention classes set up and run,
and the docs generator produces a complete site."""
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_asv_classes_smoke():
    suite = _load("benchmarks/asv_suite.py", "asv_suite")
    b = suite.TimeEnvs()
    b.steps = 5
    b.setup(8, "xla")
    b.time_run(8, "xla")

    s = suite.TimeSampler()
    s.draws = 5
    s.setup(8)
    s.time_sample(8)

    r = suite.TimeReset()
    r.setup(4)
    r.time_reset(4)

    m = suite.MemState()
    m.setup(8)
    per_env = m.track_state_bytes_per_env(8)
    assert 1_000 < per_env < 100_000, per_env


def test_asv_conf_points_at_suite():
    import json
    with open(os.path.join(ROOT, "asv.conf.json")) as f:
        conf = json.load(f)
    assert conf["benchmark_dir"] == "benchmarks"
    assert os.path.exists(os.path.join(ROOT, "benchmarks", "asv_suite.py"))


def test_docs_site_builds(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "build_docs.py"),
         "--out", str(tmp_path)],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    pages = sorted(p.name for p in tmp_path.iterdir())
    assert pages == ["api.html", "index.html", "perf-history.html",
                     "usage.html"], pages
    text = (tmp_path / "usage.html").read_text()
    assert "<nav>" in text and "rollout_chunked" in text


def test_perf_history_gate_fires_on_synthetic_slowdown(tmp_path):
    """The CI regression gate must fail a candidate whose rollout metric
    slid >25% (+ the 30 ms absolute floor) vs stored history, and pass an
    identical candidate."""
    import copy
    import glob
    import importlib.util
    import json
    import os

    root = os.path.join(os.path.dirname(__file__), "..")
    spec = importlib.util.spec_from_file_location(
        "perf_history", os.path.join(root, "tools", "perf_history.py"))
    ph = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ph)

    hist = sorted(glob.glob(os.path.join(root, "benchmarks", "history",
                                         "*_*.json")))
    assert hist, "stored history must exist"
    base = json.load(open(hist[-1]))
    key = "TimeEnvs.time_run(256, 'xla')"
    assert key in base["results"], "rollout metric must be tracked"

    ok = tmp_path / "ok.json"
    json.dump(base, open(ok, "w"))
    assert ph.check(str(ok), os.path.join(root, "benchmarks", "history"),
                    0.25) == 0

    slow = copy.deepcopy(base)
    slow["results"][key]["median_s"] = (
        base["results"][key]["median_s"] * 2 + 0.1)
    bad = tmp_path / "bad.json"
    json.dump(slow, open(bad, "w"))
    assert ph.check(str(bad), os.path.join(root, "benchmarks", "history"),
                    0.25) == 1
