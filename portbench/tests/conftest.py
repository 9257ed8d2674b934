"""The benchmark's own tests: on the CPU at a tiny size, through the
program's plain (non-CUDA) routes; the ``cuda`` tests run on a card.

    python -m pytest portbench/tests -q
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
