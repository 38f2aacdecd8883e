"""CLI: ``python -m repro_torch.analysis lint|check`` (the port of
``repro.analysis.__main__``).

* ``lint [--strict] [--format text|json|github] [paths...]`` — AST
  invariant rules R001–R008. Exits 1 when any finding survives the
  ``# repro: ignore[Rnnn]`` pragmas (and, under ``--strict``, when a
  pragma suppresses nothing).
* ``check [--depth N] [--quick] [--mutations] [--replay]`` — explicit-
  state model checking of the lifecycle / page-pool / chunked-prefill
  protocols; ``--mutations`` additionally plants known protocol bugs and
  asserts each is caught with a replayable counterexample.

Stdlib only: ``--replay`` drives the port's real gateway handle, which
imports numpy and nothing of PyTorch's device stack, so every flag runs
on any machine.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.lint import RULES, run_lint


def _emit_lint(findings, fmt: str):
    if fmt == "json":
        print(json.dumps([{
            "rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
            "message": f.message, "hint": f.hint} for f in findings],
            indent=2))
        return
    for f in findings:
        if fmt == "github":
            # GitHub Actions workflow command: annotates the PR diff
            msg = f.message + (f" (hint: {f.hint})" if f.hint else "")
            print(f"::error file={f.path},line={f.line},col={f.col},"
                  f"title={f.rule}::{msg}")
        else:
            print(f.format())


def _cmd_lint(args) -> int:
    if args.list_rules:
        for rid, desc in sorted(RULES.items()):
            print(f"{rid}  {desc}")
        return 0
    findings = run_lint(args.root, args.paths or None, strict=args.strict)
    _emit_lint(findings, args.format)
    n = len(findings)
    if n:
        if args.format == "text":
            print(f"\n{n} finding{'s' if n != 1 else ''} "
                  f"(suppress a deliberate violation with "
                  f"`# repro: ignore[Rnnn]` on the offending line)")
        return 1
    if args.format == "text":
        print("repro_torch.analysis lint: clean")
    return 0


def _cmd_check(args) -> int:
    from repro_torch.analysis import modelcheck as mc

    rc = 0
    results = mc.run_check(depth=args.depth, quick=args.quick)
    for r in results:
        status = "ok" if r.ok else f"{len(r.violations)} VIOLATION(S)"
        print(f"check[{r.model}]: {r.states} states, "
              f"{r.transitions} transitions, depth {r.depth}: {status}")
        for v in r.violations:
            print(v.format())
        if not r.ok:
            rc = 1
    if args.mutations:
        muts = mc.run_mutations(depth=args.depth,
                                lifecycle_replay=args.replay)
        for m in muts:
            verdict = "caught" if m.caught else "MISSED"
            rep = {True: ", replay confirmed", False: ", REPLAY DIVERGED",
                   None: ""}[m.replayed]
            print(f"mutation[{m.name}] ({m.model}): {verdict}{rep}")
            if m.caught:
                print(f"    {m.message}")
                print(f"    trace: {' -> '.join(m.trace) or '(initial)'}")
        missed = [m.name for m in muts if not m.caught]
        diverged = [m.name for m in muts if m.replayed is False]
        if missed:
            print(f"mutation harness: checker MISSED {missed}")
            rc = 1
        if diverged:
            print(f"mutation harness: counterexamples did not reproduce "
                  f"on the real code: {diverged}")
            rc = 1
        if not missed and not diverged:
            print(f"mutation harness: all {len(muts)} planted bugs caught")
    if rc == 0:
        print("repro_torch.analysis check: clean")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lint = sub.add_parser("lint", help="run invariant rules R001-R008")
    lint.add_argument("paths", nargs="*",
                      help="files/dirs relative to the repo root "
                           "(default: src/repro_torch tests)")
    lint.add_argument("--root", default=".",
                      help="repo root (default: cwd)")
    lint.add_argument("--strict", action="store_true",
                      help="also fail on unused ignore pragmas")
    lint.add_argument("--format", choices=("text", "json", "github"),
                      default="text",
                      help="text (default), json (machine-readable), or "
                           "github (::error workflow annotations)")
    lint.add_argument("--list-rules", action="store_true",
                      help="print the rule table and exit")

    chk = sub.add_parser(
        "check", help="model-check the lifecycle/pool/chunk protocols")
    chk.add_argument("--depth", type=int, default=12,
                     help="BFS event-depth bound (default 12)")
    chk.add_argument("--quick", action="store_true",
                     help="reduced depth for the tier-1 CI lane (<60s)")
    chk.add_argument("--mutations", action="store_true",
                     help="plant known protocol bugs and assert each is "
                          "caught with a replayable counterexample")
    chk.add_argument("--replay", action="store_true",
                     help="replay lifecycle counterexamples through the "
                          "real RequestHandle under VirtualClock "
                          "(repro_torch.serving.gateway; pool/chunk "
                          "traces always replay)")
    args = ap.parse_args(argv)

    if args.cmd == "lint":
        return _cmd_lint(args)
    return _cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())
