#!/usr/bin/env python3
"""Tracked performance history over the asv-convention benchmark classes.

The reference publishes an airspeed-velocity dashboard (reference:
README.md:12, benchmarks/benchmarks.py); this environment has no ``asv``
package, so this tool implements the same machinery over the SAME
benchmark classes (benchmarks/asv_suite.py): run a reduced CPU-lane grid,
store a results JSON under ``benchmarks/history/``, gate CI on
regressions against the stored baseline, and render the history table
for the docs site.

    python tools/perf_history.py run   [--out benchmarks/history]
    python tools/perf_history.py check [--candidate <file-or-dir>]
                                       [--against benchmarks/history]
                                       [--threshold 0.25]
    python tools/perf_history.py report [--out docs/perf-history.md]

``check`` exits 1 if any timed metric in the candidate is more than
``threshold`` slower than the median of the last up-to-3 stored runs
(and slower by an absolute floor of 30 ms, so micro-timings can't flap
the gate). ``run`` appends a new JSON named ``<utc>_<sha>.json``.
"""
import argparse
import datetime
import glob
import json
import os
import platform
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the CPU lane: these timings gate CI regressions, not device speed
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(ROOT, ".jax_cache"))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])

# CPU-lane grid: stable sub-second-to-few-second workloads per metric
# (the full asv grid incl. 4096-env combos is for asv hosts)
GRID = [
    # attr overrides push each metric to ~0.3-1 s so the regression
    # gate's absolute noise floor (50 ms) cannot mask a real 25% slide
    ("TimeEnvs", "time_run", (256, "xla"), {"steps": 600}),
    ("TimeSampler", "time_sample", (256,), {"draws": 12000}),
    # reset events: full vectorised reset incl. map procgen (the mapgen
    # trip loop + finalize + reset body — the with-resets ratio's cost)
    ("TimeReset", "time_reset", (256,), {}),
]
REPS = 5


def _suite():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "asv_suite", os.path.join(ROOT, "benchmarks", "asv_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha():
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              cwd=ROOT, capture_output=True,
                              text=True).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def run(out_dir):
    import jax
    jax.config.update("jax_compilation_cache_dir",
                      os.environ["JAX_COMPILATION_CACHE_DIR"])
    suite = _suite()
    results = {}
    for cls_name, meth, combo, attrs in GRID:
        cls = getattr(suite, cls_name)
        bench = cls()
        for k, v in attrs.items():
            setattr(bench, k, v)
        t0 = time.perf_counter()
        bench.setup(*combo)
        setup_s = time.perf_counter() - t0
        fn = getattr(bench, meth)
        fn(*combo)                      # warm (past any lazy compiles)
        reps = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn(*combo)
            reps.append(time.perf_counter() - t0)
        key = f"{cls_name}.{meth}{combo}"
        results[key] = {"median_s": statistics.median(reps),
                        "reps_s": [round(r, 6) for r in reps],
                        "setup_s": round(setup_s, 3)}
        print(f"{key}: median {results[key]['median_s']*1e3:.1f} ms",
              flush=True)
    doc = {
        "schema": 1,
        "commit": _sha(),
        "utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
        "machine": {"platform": platform.platform(),
                    "python": platform.python_version(),
                    "cpus": os.cpu_count()},
        "results": results,
    }
    os.makedirs(out_dir, exist_ok=True)
    stamp = doc["utc"].replace(":", "").replace("-", "").replace("+0000",
                                                                 "Z")
    path = os.path.join(out_dir, f"{stamp}_{doc['commit']}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    print(f"wrote {path}")
    return path


def _history_files(dirname):
    return sorted(glob.glob(os.path.join(dirname, "*_*.json")))


def check(candidate, against, threshold, abs_floor=0.03):
    if os.path.isdir(candidate):
        files = _history_files(candidate)
        if not files:
            print("no candidate results")
            return 1
        candidate = files[-1]
    with open(candidate) as f:
        cand = json.load(f)
    base_files = [p for p in _history_files(against)
                  if os.path.abspath(p) != os.path.abspath(candidate)]
    if not base_files:
        print("no stored baseline; candidate accepted")
        return 0
    # Regression gating is only meaningful against the SAME machine
    # class: absolute CPU-lane timings differ far more than the 25%
    # threshold across hosts. Filter stored runs to the candidate's
    # (platform, cpus); with no same-machine baseline, accept (the run
    # itself still appends a baseline for future same-machine checks).
    all_bases = []
    for p in base_files:
        with open(p) as f:
            all_bases.append(json.load(f))
    cm = cand.get("machine", {})
    same = [b for b in all_bases
            if b.get("machine", {}).get("platform") == cm.get("platform")
            and b.get("machine", {}).get("cpus") == cm.get("cpus")]
    if not same:
        print("no same-machine baseline "
              f"({cm.get('platform')}, {cm.get('cpus')} cpus); "
              "candidate accepted")
        return 0
    # median over the last up-to-3 same-machine runs, per metric
    bases = same[-3:]
    failed = False
    for key, r in sorted(cand["results"].items()):
        prior = [b["results"][key]["median_s"] for b in bases
                 if key in b.get("results", {})]
        if not prior:
            print(f"{key}: new metric ({r['median_s']*1e3:.1f} ms)")
            continue
        base = statistics.median(prior)
        cur = r["median_s"]
        ratio = cur / base if base > 0 else 1.0
        verdict = "ok"
        if ratio > 1 + threshold and cur - base > abs_floor:
            verdict = "REGRESSION"
            failed = True
        print(f"{key}: {cur*1e3:.1f} ms vs baseline {base*1e3:.1f} ms "
              f"(x{ratio:.2f}) {verdict}")
    return 1 if failed else 0


def report(out_path):
    rows = []
    for p in _history_files(os.path.join(ROOT, "benchmarks", "history")):
        with open(p) as f:
            d = json.load(f)
        rows.append(d)
    keys = sorted({k for d in rows for k in d["results"]})
    lines = ["# Performance history (CPU lane)", "",
             "Stored by `python tools/perf_history.py run`; CI gates on "
             ">25% regression vs the last stored runs "
             "(`.github/workflows/tests.yml` perf-history job). Times in "
             "ms (median of 5).", ""]
    header = "| commit | utc | " + " | ".join(keys) + " |"
    lines.append(header)
    lines.append("|" + "---|" * (2 + len(keys)))
    for d in rows:
        cells = [d["commit"], d["utc"]]
        for k in keys:
            r = d["results"].get(k)
            cells.append(f"{r['median_s']*1e3:.1f}" if r else "—")
        lines.append("| " + " | ".join(cells) + " |")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out_path} ({len(rows)} runs)")
    return 0


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run")
    p_run.add_argument("--out",
                       default=os.path.join(ROOT, "benchmarks", "history"))
    p_chk = sub.add_parser("check")
    p_chk.add_argument("--candidate",
                       default=os.path.join(ROOT, "benchmarks", "history"))
    p_chk.add_argument("--against",
                       default=os.path.join(ROOT, "benchmarks", "history"))
    p_chk.add_argument("--threshold", type=float, default=0.25)
    p_rep = sub.add_parser("report")
    p_rep.add_argument("--out",
                       default=os.path.join(ROOT, "docs",
                                            "perf-history.md"))
    args = ap.parse_args()
    if args.cmd == "run":
        run(args.out)
        return 0
    if args.cmd == "check":
        return check(args.candidate, args.against, args.threshold)
    return report(args.out)


if __name__ == "__main__":
    sys.exit(main())
