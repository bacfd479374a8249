"""CLI: ``python -m celestia_tpu_torch.scenarios <name> [options]`` (port of
the JAX package's scenarios CLI; ``--device`` picks the world's device,
default ``cuda``; the JAX CLI's ``--san`` waits for the sanitizer's port)."""

from __future__ import annotations

import argparse
import json
import sys

from . import library
from .engine import run_scenario


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m celestia_tpu_torch.scenarios",
        description="run a declarative robustness scenario and judge it "
                    "by the node's own SLO engine")
    p.add_argument("name", nargs="?", help="scenario name (see --list)")
    p.add_argument("--list", action="store_true",
                   help="list shipped scenarios and exit")
    p.add_argument("--seed", type=int, default=1337,
                   help="seed pinning traffic shapes, sample coordinates "
                        "and the fault timeline (default 1337)")
    p.add_argument("--duration-scale", type=float, default=1.0,
                   help="multiply every phase duration (CI may shrink, "
                        "soak may stretch)")
    p.add_argument("--report", metavar="PATH",
                   help="write the machine-readable scenario report here")
    p.add_argument("--ledger", metavar="PATH",
                   help="append a {pass, breaches} run record to this "
                        "scenario ledger (read by make bench-gate)")
    p.add_argument("--record", metavar="PATH",
                   help="record the run's /metrics into this .ctts "
                        "file (tools/tsdb.py); implied to a temp file "
                        "when the scenario sets record_cadence_s")
    p.add_argument("--soak-ledger", metavar="PATH",
                   help="append a {drift_breaches, knee} run record to "
                        "this soak ledger (read by make bench-gate)")
    p.add_argument("--inject-leak", action="store_true",
                   help="run a synthetic monotone-gauge leak the drift "
                        "verdict MUST flag (red-path self-test; the "
                        "run is EXPECTED to fail)")
    p.add_argument("--inject-retrace", action="store_true",
                   help="churn synthetic post-warmup shape keys the "
                        "zero_steadystate_retraces invariant MUST flag "
                        "(red-path self-test; the run is EXPECTED to "
                        "fail)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the report summary on stdout")
    p.add_argument("--device", default="cuda",
                   help="the world's device: cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.list:
        for name in sorted(library.SCENARIOS):
            print(f"{name:20s} {library.SCENARIOS[name]().description}")
        return 0
    if not args.name:
        p.error("scenario name required (or --list)")
    try:
        scenario = library.get(args.name)
    except KeyError as e:
        p.error(str(e))

    report = run_scenario(scenario, seed=args.seed,
                          duration_scale=args.duration_scale,
                          report_path=args.report,
                          ledger_path=args.ledger,
                          record_path=args.record,
                          soak_ledger_path=args.soak_ledger,
                          inject_leak=args.inject_leak,
                          inject_retrace=args.inject_retrace,
                          device=args.device)
    if not args.quiet:
        _summarize(report)
    return 0 if report["scenario_slo_pass"] else 1


def _summarize(report: dict) -> None:
    v = report["verdict"]
    status = "PASS" if report["scenario_slo_pass"] else "FAIL"
    print(f"scenario {report['scenario']} seed={report['seed']} "
          f"wall={report['wall_s']}s: {status}")
    for ph in report["phases"]:
        print(f"  phase {ph['name']:20s} slo_ok={ph['slo']['ok']} "
              f"faults={len(ph['faults'])}")
    for inv in report["invariants"]:
        mark = "ok " if inv["ok"] else "FAIL"
        print(f"  invariant {mark} {inv['name']}: {inv['detail']}")
    if v["breaching_objectives"]:
        print(f"  breaching objectives: {v['breaching_objectives']}")
    if v["unexpected_breaches"]:
        print(f"  UNEXPECTED breaches: {v['unexpected_breaches']}")
    if v["missing_required_breaches"]:
        print(f"  MISSING required breaches: "
              f"{v['missing_required_breaches']}")
    w = report["world"]
    print(f"  world: heights={w['heights']} das={w['das']} "
          f"pfb={w['pfb']} mempool={w['mempool']}")
    rec = report.get("recording")
    if rec:
        print(f"  recording: {rec.get('samples', 0)} samples / "
              f"{rec.get('series', 0)} series @ {rec.get('cadence_s')}s "
              f"({rec.get('scrapes')} scrapes, "
              f"{rec.get('overruns')} overruns, "
              f"{rec.get('counter_resets')} counter resets)")
    for d in report.get("drift") or ():
        mark = "DRIFTING" if d.get("drifting") else "flat"
        note = d.get("note")
        extra = (f" rel_growth={d['rel_growth']:.2f}"
                 if "rel_growth" in d else f" ({note})" if note else "")
        print(f"  drift {mark:8s} {d['series']}{extra}")
    curve = report.get("load_curve")
    if curve:
        for s in curve["steps"]:
            print(f"  load {s['planned_hz']:8.1f} Hz planned -> "
                  f"offered {s['offered_hz']:8.1f} goodput "
                  f"{s['goodput_hz']:8.1f} p50={s['p50_s']:.4f}s "
                  f"p99={s['p99_s']:.4f}s")
        knee = curve["knee"]
        print(f"  knee: {knee}")
    if not report["scenario_slo_pass"]:
        print(json.dumps(v, indent=2), file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
