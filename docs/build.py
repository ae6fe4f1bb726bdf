#!/usr/bin/env python
"""Generate API documentation for warpsense (stdlib pydoc, no deps).

The reference ships a Doxygen target (`catkin_make docs`,
/root/reference/docs/CMakeLists.txt:1-8 + docs/Doxyfile); this is that
role: `python docs/build.py` writes one HTML page per module plus an
index to docs/api/.
"""
from __future__ import annotations

import pkgutil
import pydoc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = Path(__file__).resolve().parent / "api"


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")   # never touch hardware
    import warpsense

    OUT.mkdir(parents=True, exist_ok=True)
    names = ["warpsense"]
    for m in pkgutil.walk_packages(warpsense.__path__,
                                   prefix="warpsense."):
        names.append(m.name)

    written = []
    for name in sorted(names):
        try:
            obj = pydoc.locate(name, forceload=0)
            if obj is None:
                continue
            html = pydoc.HTMLDoc().page(pydoc.describe(obj),
                                        pydoc.html.document(obj, name))
            (OUT / f"{name}.html").write_text(html)
            written.append(name)
        except Exception as e:       # modules with optional deps
            print(f"skip {name}: {e}", file=sys.stderr)

    index = ["<html><head><title>warpsense API</title></head><body>",
             "<h1>warpsense API documentation</h1>",
             "<p>Generated by docs/build.py (stdlib pydoc).</p><ul>"]
    for name in written:
        index.append(f'<li><a href="{name}.html">{name}</a></li>')
    index.append("</ul></body></html>")
    (OUT / "index.html").write_text("\n".join(index))
    print(f"wrote {len(written)} module pages + index to {OUT}")


if __name__ == "__main__":
    main()
