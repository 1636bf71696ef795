"""The check that nothing the benchmark runs loads JAX or the JAX package.

Names are compared whole by their top-level part (before the first dot):
``vszip_tpu_torch``, the program under test, begins with ``vszip_tpu``, the
JAX package it was ported from, and is not that package.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vszip_tpu"})


def loaded() -> list[str]:
    """The forbidden top-level modules in this process's ``sys.modules``."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def refuse(when: str) -> None:
    """Ends the process, naming what it found on standard error, when a
    forbidden module is loaded; a run calls it after set-up and as its last
    step before the result is printed."""
    bad = loaded()
    if bad:
        raise SystemExit(f"portbench: loaded {when}: {', '.join(bad)}")


def in_sources(folder: Path) -> list[str]:
    """``file: module`` for every import of a forbidden module in the Python
    files under `folder`."""
    found = []
    for path in sorted(folder.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            found += [f"{path.relative_to(folder.parent)}: {n}" for n in names
                      if n.split(".")[0] in FORBIDDEN]
    return found
