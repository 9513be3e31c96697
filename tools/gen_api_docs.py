#!/usr/bin/env python3
"""Generate docs/api.md: an API reference for the public surface.

The reference ships Sphinx autodoc + readthedocs (reference:
docs/source/conf.py, docs/source/api.rst); this environment has no Sphinx,
so the equivalent is a small introspection-based generator over the same
module list. Run from the repo root:

    python tools/gen_api_docs.py [--check]

``--check`` exits 1 if docs/api.md is stale (CI hook).
"""
import argparse
import importlib
import inspect
import io
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

MODULES = [
    ("eldorado_tpu", "Package root"),
    ("eldorado_tpu.vec", "Vectorised environments & rollouts"),
    ("eldorado_tpu.stream", "Per-step learner feed (packed records + ring)"),
    ("eldorado_tpu.compat", "city_of_gold API mirror"),
    ("eldorado_tpu.compat.vec", "city_of_gold.vec API mirror"),
    ("eldorado_tpu.parallel.mesh", "Device-mesh construction & sharding"),
    ("eldorado_tpu.parallel.runner", "Sharded runner"),
    ("eldorado_tpu.parallel.bootstrap", "Multi-process (pod) bootstrap"),
    ("eldorado_tpu.core.engine", "Single-env engine (jitted reset/step)"),
    ("eldorado_tpu.core.mapgen", "On-device procedural map generation"),
    ("eldorado_tpu.ops.rng", "Bit-exact libstdc++ RNG streams"),
    ("eldorado_tpu.errors", "Exceptions"),
    ("eldorado_tpu.render", "ANSI renderer"),
    ("eldorado_tpu.native", "Optional C++ helpers (obs packing, ring)"),
    ("eldorado_tpu.constants", "Game constants & enums"),
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + line for line in d.splitlines())


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        # skip re-exports defined elsewhere, except in aggregator modules
        owner = getattr(obj, "__module__", mod.__name__)
        if (inspect.isfunction(obj) or inspect.isclass(obj)) \
                and owner != mod.__name__ \
                and not mod.__name__.endswith("compat") \
                and mod.__name__ != "eldorado_tpu":
            continue
        out.append((n, obj))
    return out


def generate():
    buf = io.StringIO()
    w = buf.write
    w("# eldorado_tpu API reference\n\n")
    w("Generated by `python tools/gen_api_docs.py` — do not edit by "
      "hand.\nMirrors the reference's Sphinx autodoc surface "
      "(reference: docs/source/api.rst).\n")
    for modname, blurb in MODULES:
        try:
            mod = importlib.import_module(modname)
        except Exception as e:  # e.g. native toolchain missing
            w(f"\n## `{modname}` — {blurb}\n\n*(unavailable: {e})*\n")
            continue
        w(f"\n## `{modname}` — {blurb}\n\n")
        head = _doc(mod)
        if head:
            w(head + "\n")
        for name, obj in _public_members(mod):
            if inspect.isclass(obj):
                w(f"\n### class `{name}{_sig(obj)}`\n\n")
                d = _doc(obj)
                if d:
                    w(d + "\n")
                for mname, meth in inspect.getmembers(obj):
                    if mname.startswith("_") or not callable(meth):
                        continue
                    if not (inspect.isfunction(meth)
                            or inspect.ismethod(meth)):
                        continue
                    w(f"\n**`.{mname}{_sig(meth)}`**\n\n")
                    d = _doc(meth)
                    if d:
                        w(d + "\n")
                for pname, prop in inspect.getmembers(
                        obj, lambda o: isinstance(o, property)):
                    if pname.startswith("_"):
                        continue
                    w(f"\n**`.{pname}`** *(property)*\n\n")
                    d = _doc(prop)
                    if d:
                        w(d + "\n")
            elif callable(obj):
                w(f"\n### `{name}{_sig(obj)}`\n\n")
                d = _doc(obj)
                if d:
                    w(d + "\n")
    return buf.getvalue()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "docs", "api.md")
    text = generate()
    if args.check:
        with open(out) as f:
            if f.read() != text:
                print("docs/api.md is stale: run python tools/gen_api_docs.py")
                return 1
        print("docs/api.md up to date")
        return 0
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out} ({len(text)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
