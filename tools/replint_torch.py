#!/usr/bin/env python3
"""replint CLI for the port — device-code lint over the torch sources.

Usage:
    python tools/replint_torch.py src/repro_torch [--strict] [--json out.json]
    python tools/replint_torch.py --list-rules

Prints findings as ``path:line:col: rule: message``.  With ``--strict``
the process exits 1 when any finding survives suppression filtering.
``--json`` also writes the findings as a machine-readable array.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.analysis.lint import RULES, lint_paths  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*",
                        help="files or directories to lint")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 when any finding remains")
    parser.add_argument("--json", metavar="FILE", default=None,
                        help="write findings as JSON to FILE")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule}: {desc}")
        return 0
    if not args.paths:
        parser.error("paths required (or --list-rules)")

    findings = lint_paths(args.paths)
    for f in findings:
        print(f)

    if args.json:
        Path(args.json).write_text(
            json.dumps([asdict(f) for f in findings], indent=2) + "\n",
            encoding="utf-8")

    n = len(findings)
    print(f"replint: {n} finding(s)" if n else "replint: clean",
          file=sys.stderr)
    return 1 if (n and args.strict) else 0


if __name__ == "__main__":
    raise SystemExit(main())
