#!/usr/bin/env python3
"""Build a static HTML documentation site from README.md + docs/*.md.

The reference ships Sphinx autodoc + readthedocs (reference:
docs/source/conf.py, .readthedocs.yaml); this environment has no Sphinx,
so the buildable-docs target is this self-contained generator over the
same content: the hand-written guide (docs/usage.md) plus the introspection-generated API reference (docs/api.md, kept fresh by
tools/gen_api_docs.py --check in CI).

    python tools/build_docs.py [--out docs/_site]

Outputs one HTML page per source file with a shared nav sidebar; exit 0
and a non-empty site dir is the CI contract (tests/test_docs.py builds it).
"""
import argparse
import html
import os
import sys

import markdown

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAGES = [
    ("index", "README.md", "Overview"),
    ("usage", "docs/usage.md", "Usage guide"),
    ("perf-history", "docs/perf-history.md", "Perf history"),
    ("api", "docs/api.md", "API reference"),
]

_CSS = """
body { font-family: -apple-system, system-ui, sans-serif; margin: 0;
       color: #1a1a1a; line-height: 1.55; }
.wrap { display: flex; max-width: 72rem; margin: 0 auto; }
nav { min-width: 11rem; padding: 2rem 1rem; border-right: 1px solid #ddd; }
nav a { display: block; padding: .25rem 0; color: #246;
        text-decoration: none; }
nav a.active { font-weight: 700; }
main { padding: 2rem 2.5rem; min-width: 0; }
pre { background: #f6f8fa; padding: .8rem 1rem; overflow-x: auto;
      border-radius: 6px; font-size: .88em; }
code { background: #f0f2f4; padding: .08em .3em; border-radius: 4px;
       font-size: .92em; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; }
th, td { border: 1px solid #ccc; padding: .3rem .6rem; }
h1, h2, h3 { line-height: 1.25; }
"""

_TPL = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — eldorado_tpu</title><style>{css}</style></head>
<body><div class="wrap"><nav><strong>eldorado_tpu</strong>{nav}</nav>
<main>{body}</main></div></body></html>
"""


def build(out_dir):
    md = markdown.Markdown(extensions=["fenced_code", "tables"])
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for slug, rel, title in PAGES:
        src = os.path.join(ROOT, rel)
        if not os.path.exists(src):
            print(f"skipping missing {rel}", file=sys.stderr)
            continue
        with open(src) as f:
            body = md.reset().convert(f.read())
        nav = "".join(
            f'<a href="{s}.html"'
            + (' class="active"' if s == slug else "")
            + f">{html.escape(t)}</a>"
            for s, r, t in PAGES if os.path.exists(os.path.join(ROOT, r)))
        page = _TPL.format(title=html.escape(title), css=_CSS, nav=nav,
                           body=body)
        dst = os.path.join(out_dir, f"{slug}.html")
        with open(dst, "w") as f:
            f.write(page)
        written.append(dst)
    return written


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "_site"))
    args = ap.parse_args()
    written = build(args.out)
    if not written:
        print("no pages built", file=sys.stderr)
        return 1
    print(f"built {len(written)} pages -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
