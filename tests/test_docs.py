"""Every ```python block in README.md and docs/*.md must execute.

Guards the documentation against API drift (round-2 verdict found three
examples that crashed: a packed-mask regression, a removed runner kwarg,
and a changed ring.pop signature). Snippets run verbatim except for a
size-scaling table (big batch / step counts shrink so the CPU lane stays
fast — the API surface exercised is identical).
"""
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# literal → scaled-down literal, applied as plain substring replacement
# inside snippet text only (checked to stay whole-token by the doc text)
_SCALE = [
    ("N, T = 4096, 6000", "N, T = 32, 40"),
    ("T, chunk=1500, block=512", "T, chunk=20, block=8"),
    ("N, T = 1024, 400", "N, T = 16, 10"),
    ("T, chunk=100, block=512, steps_per_push=50",
     "T, chunk=5, block=8, steps_per_push=5"),
    ("4096", "32"),
    ("8192", "64"),
    ("65536", "64"),
    ("1024", "16"),
    ("n_steps=10_000", "n_steps=40"),
    ("rngs, 10_000, chunk=1500", "rngs, 20, chunk=10"),
    ("rollout_chunked(10_000, chunk=1500, block=512)",
     "rollout_chunked(40, chunk=10, block=8)"),
    ("block=512", "block=16"),
    ("runner.rollout(500)", "runner.rollout(5)"),
    ("n_steps=500", "n_steps=10"),
    ("CHUNK = 100", "CHUNK = 4"),
]


def _blocks():
    files = [ROOT / "README.md"] + sorted((ROOT / "docs").glob("*.md"))
    out = []
    for f in files:
        text = f.read_text()
        for i, m in enumerate(
                re.finditer(r"```python\n(.*?)```", text, re.S)):
            out.append(pytest.param(f.name, m.group(1),
                                    id=f"{f.name}#{i}"))
    return out


_BLOCKS = _blocks()


def test_docs_have_snippets():
    assert len(_BLOCKS) >= 7, "doc snippets went missing"


def test_api_md_fresh():
    """docs/api.md must match the generator output (CI gate, run locally).

    Round-3 verdict W3: a docstring edit landed without regenerating
    docs/api.md, turning CI red at HEAD. Running the same freshness check
    in the normal test lane makes `pytest` catch it before commit.
    """
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_api_docs", ROOT / "tools" / "gen_api_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    current = (ROOT / "docs" / "api.md").read_text()
    assert current == mod.generate(), \
        "docs/api.md is stale: run python tools/gen_api_docs.py"


@pytest.mark.parametrize("fname,code", _BLOCKS)
def test_doc_snippet_runs(fname, code):
    if "native.TrajectoryRing" in code or (
            "stream.stream_rollout" in code
            and 'deliver="device"' not in code):
        from eldorado_tpu import native
        if not native.available():
            pytest.skip("native toolchain unavailable")
    for a, b in _SCALE:
        code = code.replace(a, b)
    exec(compile(code, f"<doc:{fname}>", "exec"), {"__name__": "__doc__"})
