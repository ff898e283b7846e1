"""CLI entry point: ``python -m repro_torch.check``.

The port's trilint, with the reference's flags, JSON report and exit
status: 0 when no unsuppressed findings, 1 otherwise, 2 on usage errors.
``--json`` emits a machine-readable report for CI.  The default root is
the ``repro_torch`` package and the default allowlist the port's own
``src/repro_torch/check/trilint.allow`` (the repo-root ``trilint.allow``
is the reference's).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .base import load_passes, run_checks

_PKG_DIR = Path(__file__).resolve().parent  # src/repro_torch/check
_DEFAULT_ROOT = _PKG_DIR.parent  # src/repro_torch
_DEFAULT_ALLOWLIST = _PKG_DIR / "trilint.allow"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="trilint: repo-specific static analysis for the triangle engine's port",
    )
    parser.add_argument(
        "--root",
        type=Path,
        default=_DEFAULT_ROOT,
        help="directory tree to scan (default: the repro_torch package)",
    )
    parser.add_argument(
        "--allowlist",
        type=Path,
        default=None,
        help="allowlist file (default: src/repro_torch/check/trilint.allow)",
    )
    parser.add_argument(
        "--no-allowlist",
        action="store_true",
        help="ignore any allowlist file",
    )
    parser.add_argument(
        "--select",
        default=None,
        help="comma-separated pass names (default: all)",
    )
    parser.add_argument("--json", action="store_true", help="emit a JSON report")
    parser.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print suppressed findings in text mode",
    )
    parser.add_argument(
        "--list-passes", action="store_true", help="list registered passes and exit"
    )
    args = parser.parse_args(argv)

    if args.list_passes:
        for name in sorted(load_passes()):
            print(name)
        return 0

    allowlist = None
    if not args.no_allowlist:
        allowlist = args.allowlist
        if allowlist is None and _DEFAULT_ALLOWLIST.exists():
            allowlist = _DEFAULT_ALLOWLIST

    select = [s.strip() for s in args.select.split(",") if s.strip()] if args.select else None

    try:
        findings = run_checks(args.root, allowlist_path=allowlist, select=select)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    unsuppressed = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]

    if args.json:
        report = {
            "root": str(args.root),
            "allowlist": str(allowlist) if allowlist else None,
            "passes": select or sorted(load_passes()),
            "counts": {
                "total": len(findings),
                "unsuppressed": len(unsuppressed),
                "suppressed": len(suppressed),
            },
            "findings": [f.to_dict() for f in findings],
        }
        print(json.dumps(report, indent=2))
    else:
        for f in unsuppressed:
            print(f.render())
        if args.show_suppressed:
            for f in suppressed:
                print(f.render())
        print(
            f"trilint: {len(unsuppressed)} finding(s), "
            f"{len(suppressed)} suppressed"
        )

    return 1 if unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
