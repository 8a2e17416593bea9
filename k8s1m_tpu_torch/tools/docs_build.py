"""Docs pipeline: render the repo's markdown docs to a static HTML site
(the port's copy of ``k8s1m_tpu/tools/docs_build.py``, standard library only).

The reference publishes its asciidoc docs through an asciidoctor->HTML
pipeline (SURVEY §2 item 16); this is the same role for this repo's
markdown set, dependency-free: ``python -m k8s1m_tpu_torch.tools.docs_build
--out docs/site`` renders README.md, PARITY.md, and friends with an
index page.  The converter covers the subset these docs use — headings,
fenced code, tables, lists, links, emphasis — not all of markdown.
"""

from __future__ import annotations

import argparse
import html
import pathlib
import re
import sys

DEFAULT_DOCS = ["README.md", "MIGRATION.md", "PARITY.md", "SURVEY.md", "BASELINE.md"]

_STYLE = """
body { max-width: 60rem; margin: 2rem auto; padding: 0 1rem;
       font: 16px/1.55 system-ui, sans-serif; color: #1a1a1a; }
pre { background: #f6f8fa; padding: .8rem; overflow-x: auto;
      border-radius: 6px; font-size: 85%; }
code { background: #f6f8fa; padding: .1em .3em; border-radius: 4px;
       font-size: 90%; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1rem 0; display: block;
        overflow-x: auto; }
th, td { border: 1px solid #d0d7de; padding: .35rem .7rem;
         text-align: left; vertical-align: top; }
th { background: #f6f8fa; }
h1, h2, h3 { line-height: 1.25; }
a { color: #0969da; text-decoration: none; }
a:hover { text-decoration: underline; }
nav { border-bottom: 1px solid #d0d7de; padding-bottom: .5rem;
      margin-bottom: 1.5rem; }
"""


def _inline(text: str) -> str:
    text = html.escape(text, quote=False)
    text = re.sub(r"`([^`]+)`", r"<code>\1</code>", text)
    text = re.sub(r"\*\*([^*]+)\*\*", r"<strong>\1</strong>", text)
    text = re.sub(r"(?<!\w)\*([^*]+)\*(?!\w)", r"<em>\1</em>", text)
    text = re.sub(
        r"\[([^\]]+)\]\(([^)\s]+)\)",
        lambda m: f'<a href="{re.sub(r"[.]md$", ".html", m.group(2))}">'
        f"{m.group(1)}</a>",
        text,
    )
    return text


def md_to_html(src: str) -> str:
    out: list[str] = []
    lines = src.splitlines()
    i = 0
    in_list = False

    def close_list():
        nonlocal in_list
        if in_list:
            out.append("</ul>")
            in_list = False

    while i < len(lines):
        line = lines[i]
        if line.startswith("```"):
            close_list()
            i += 1
            block = []
            while i < len(lines) and not lines[i].startswith("```"):
                block.append(lines[i])
                i += 1
            i += 1
            out.append(
                "<pre><code>" + html.escape("\n".join(block)) + "</code></pre>"
            )
            continue
        if line.startswith("|") and i + 1 < len(lines) and re.match(
            r"^\|[\s:|-]+\|?\s*$", lines[i + 1]
        ):
            close_list()
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            out.append("<table><thead><tr>")
            out += [f"<th>{_inline(c)}</th>" for c in cells]
            out.append("</tr></thead><tbody>")
            i += 2
            while i < len(lines) and lines[i].startswith("|"):
                row = [c.strip() for c in lines[i].strip().strip("|").split("|")]
                out.append(
                    "<tr>" + "".join(f"<td>{_inline(c)}</td>" for c in row)
                    + "</tr>"
                )
                i += 1
            out.append("</tbody></table>")
            continue
        m = re.match(r"^(#{1,6})\s+(.*)$", line)
        if m:
            close_list()
            n = len(m.group(1))
            out.append(f"<h{n}>{_inline(m.group(2))}</h{n}>")
        elif re.match(r"^\s*[-*]\s+", line):
            if not in_list:
                out.append("<ul>")
                in_list = True
            out.append(
                "<li>" + _inline(re.sub(r"^\s*[-*]\s+", "", line)) + "</li>"
            )
        elif line.strip() == "":
            close_list()
        else:
            close_list()
            out.append(f"<p>{_inline(line)}</p>")
        i += 1
    close_list()
    return "\n".join(out)


def _page(title: str, nav: str, body: str) -> str:
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{_STYLE}</style></head>"
        f"<body><nav>{nav}</nav>{body}</body></html>"
    )


def build(repo: pathlib.Path, out: pathlib.Path, docs: list[str]) -> list[str]:
    out.mkdir(parents=True, exist_ok=True)
    present = [d for d in docs if (repo / d).exists()]
    nav = " | ".join(
        f'<a href="{pathlib.Path(d).stem.lower()}.html">'
        f"{pathlib.Path(d).stem}</a>"
        for d in ["index.md"] + present
    ).replace("index.html\">Index", "index.html\">Home")
    written = []
    for d in present:
        body = md_to_html((repo / d).read_text())
        name = pathlib.Path(d).stem.lower() + ".html"
        (out / name).write_text(_page(d, nav, body))
        written.append(name)
    index = "<h1>k8s1m-tpu documentation</h1><ul>" + "".join(
        f'<li><a href="{pathlib.Path(d).stem.lower()}.html">{d}</a></li>'
        for d in present
    ) + "</ul>"
    (out / "index.html").write_text(_page("k8s1m-tpu docs", nav, index))
    written.append("index.html")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description="build the HTML doc site")
    ap.add_argument("--repo", default=".")
    ap.add_argument("--out", default="docs/site")
    ap.add_argument("--docs", nargs="*", default=DEFAULT_DOCS)
    args = ap.parse_args(argv)
    written = build(
        pathlib.Path(args.repo), pathlib.Path(args.out), args.docs
    )
    print(f"wrote {len(written)} pages to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
