"""CLI: ``python -m repro_torch.analysis [lint|audit|races|invariants|all]``.

Runs the selected passes and prints structured findings one per line
(``location: severity: [RULE] message``).  Exit status 1 when any
error-severity finding survives.  ``--device`` (default ``cuda``) is
where the audit and races passes run the port's kernels: on the card the
audit also runs the compiled steps under sync debug mode, llama2-7b's
captured step at full width among them; ``--device cpu`` takes the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys

from .findings import format_findings

PASSES = ("lint", "audit", "races", "invariants")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis & invariant verification passes.")
    parser.add_argument("passes", nargs="*", default=["all"],
                        choices=list(PASSES) + ["all"],
                        help="passes to run (default: all)")
    parser.add_argument("--root", default="src/repro_torch",
                        help="directory (or file) the lint pass walks "
                             "(default: src/repro_torch)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the audit and races passes run the "
                             "kernels (default: cuda)")
    parser.add_argument("--json", action="store_true",
                        help="emit findings as JSON instead of text")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-pass progress lines")
    args = parser.parse_args(argv)

    selected = list(PASSES) if "all" in args.passes else \
        [p for p in PASSES if p in args.passes]
    log = (lambda s: None) if args.quiet or args.json else \
        (lambda s: print(s, file=sys.stderr))

    findings = []
    for name in selected:
        if name == "lint":
            from . import lint
            findings.extend(lint.run_pass(args.root, log=log))
        elif name == "audit":
            from . import step_audit
            findings.extend(step_audit.run_pass(log=log, device=args.device))
        elif name == "races":
            from . import races
            findings.extend(races.run_pass(log=log, device=args.device))
        elif name == "invariants":
            from . import invariants
            findings.extend(invariants.run_pass(log=log))

    if args.json:
        print(json.dumps([f.to_json() for f in findings], indent=2))
    elif findings:
        print(format_findings(findings))
    errors = sum(1 for f in findings if f.severity == "error")
    if not args.json:
        print(f"repro_torch.analysis: {len(selected)} pass(es), "
              f"{len(findings)} finding(s), {errors} error(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
