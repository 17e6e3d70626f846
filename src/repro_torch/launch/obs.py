"""Run-ledger inspection: ``python -m repro_torch.launch.obs <cmd> <run>``.

Three views over the ``telemetry/`` database a ledger-enabled run
leaves behind (``launch/insitu.py --ledger``,
``launch/catalog_serve.py --ledger``); the reference package's ledgers
read the same way:

  ``tail <run>``    live(ish) event stream: poll the ledger and print
                    newly-persisted events as they flush (``--once``
                    prints the current stream and exits — CI mode).
  ``report <run>``  postmortem: flush inventory per process, slowest
                    steps with critical-path attribution, the alert
                    timeline, crash dumps, and the run verdict. Works
                    on the ledger a SIGKILLed run left behind — every
                    committed flush is readable.
  ``export <run> --perfetto out.json``
                    one merged Chrome-trace/Perfetto JSON spanning
                    trainer, lane and server spans.

The reader merges every writer's flushes (trainer, catalog server,
relayed lane domains), so one command sees the whole run regardless of
how many processes wrote telemetry.
"""
from __future__ import annotations

import argparse
import json
import time

from ..obs.ledger import LedgerReader


def _fmt_ts(ts_us: float) -> str:
    if not ts_us:
        return "--:--:--"
    return time.strftime("%H:%M:%S", time.localtime(ts_us / 1e6)) \
        + f".{int(ts_us % 1e6) // 1000:03d}"


def _fmt_event(ev: dict) -> str:
    fields = " ".join(f"{k}={v}" for k, v in
                      sorted(ev.get("fields", {}).items()))
    return (f"{_fmt_ts(ev.get('ts_us', 0))} "
            f"[pid {ev.get('pid', '?')}] {ev.get('type', '?'):<22} "
            f"{fields}")


def _fmt_attrib(a: dict) -> str:
    stages = " ".join(f"{st}={sec * 1e3:.1f}ms"
                      for st, sec in sorted(a["stages"].items(),
                                            key=lambda kv: -kv[1]))
    tag = " PARTIAL" if a["partial"] else ""
    return (f"step {a['step']:>6}  total {a['total_s'] * 1e3:8.1f} ms  "
            f"critical={a['critical'] or '-':<8} {stages}{tag}")


def cmd_tail(args) -> int:
    seen: set = set()
    while True:
        reader = LedgerReader(args.run)
        try:
            events = reader.events()
        finally:
            reader.close()
        for ev in events:
            key = (ev.get("pid"), ev.get("seq"), ev.get("type"),
                   ev.get("ts_us"))
            if key not in seen:
                seen.add(key)
                print(_fmt_event(ev), flush=True)
        if args.once:
            return 0
        time.sleep(args.interval)


def cmd_report(args) -> int:
    reader = LedgerReader(args.run)
    try:
        flushes = reader.flushes()
        if not flushes:
            print("ledger is empty (no flush committed yet)")
            return 1
        events = reader.events(flushes)
        attribs = reader.attribs(flushes)
        alerts = reader.alerts(flushes)
        dumps = reader.crash_dumps(flushes)
        verdict = reader.verdict(flushes)

        procs: dict[str, int] = {}
        for fl in flushes:
            procs[fl["proc"]] = procs.get(fl["proc"], 0) + 1
        print(f"== run ledger: {args.run}")
        print(f"   flushes: {len(flushes)} "
              f"({', '.join(f'{p}:{n}' for p, n in sorted(procs.items()))})"
              f"; events: {len(events)}; steps attributed: {len(attribs)}")
        print(f"   verdict: {verdict.upper()}")

        if attribs:
            print(f"\n== slowest steps (critical-path attribution, "
                  f"top {args.slowest})")
            ranked = sorted(attribs.values(),
                            key=lambda a: -a["total_s"])[:args.slowest]
            for a in ranked:
                print("   " + _fmt_attrib(a))
            crit: dict[str, int] = {}
            for a in attribs.values():
                if a["critical"]:
                    crit[a["critical"]] = crit.get(a["critical"], 0) + 1
            dist = ", ".join(f"{st}:{n}" for st, n in
                             sorted(crit.items(), key=lambda kv: -kv[1]))
            print(f"   critical-path distribution: {dist}")

        if alerts:
            print("\n== alert timeline")
            for ev in alerts:
                f = ev.get("fields", {})
                cleared = f" (cleared sample {f['cleared_sample']})" \
                    if "cleared_sample" in f else " (still active)"
                print(f"   {_fmt_ts(ev.get('ts_us', 0))} "
                      f"[{f.get('severity', '?'):>4}] {f.get('rule')}: "
                      f"{f.get('signal')}={f.get('value')} "
                      f"{f.get('op')} {f.get('threshold')}{cleared}")

        if dumps:
            print("\n== crash dumps")
            for ev in dumps:
                print("   " + _fmt_event(ev))

        partial = [a for a in attribs.values() if a["partial"]]
        if partial:
            print(f"\n== interrupted steps ({len(partial)} partial "
                  f"attributions — steps in flight at a crash/dump)")
            for a in sorted(partial, key=lambda a: a["step"]):
                print("   " + _fmt_attrib(a))
    finally:
        reader.close()
    return 0


def cmd_export(args) -> int:
    reader = LedgerReader(args.run)
    try:
        if args.perfetto:
            n = reader.export_perfetto(args.perfetto)
            pids = {s["pid"] for s in reader.spans()}
            print(f"perfetto: {n} spans across {len(pids)} process(es) "
                  f"-> {args.perfetto}")
        if args.json:
            doc = {"flushes": reader.flushes(),
                   "events": reader.events(),
                   "attribs": {str(k): v
                               for k, v in reader.attribs().items()},
                   "verdict": reader.verdict()}
            with open(args.json, "w") as fh:
                json.dump(doc, fh, indent=1)
            print(f"json: {len(doc['flushes'])} flushes -> {args.json}")
        if not args.perfetto and not args.json:
            print("nothing to export: pass --perfetto PATH and/or "
                  "--json PATH")
            return 2
    finally:
        reader.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.obs",
        description="inspect the telemetry ledger of a run")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tail", help="print the persisted event stream")
    t.add_argument("run", help="run root (or its telemetry/ directory)")
    t.add_argument("--interval", type=float, default=1.0)
    t.add_argument("--once", action="store_true",
                   help="print the current stream and exit")
    t.set_defaults(fn=cmd_tail)

    r = sub.add_parser("report", help="postmortem report")
    r.add_argument("run")
    r.add_argument("--slowest", type=int, default=10,
                   help="steps to list in the attribution ranking")
    r.set_defaults(fn=cmd_report)

    e = sub.add_parser("export", help="export merged telemetry")
    e.add_argument("run")
    e.add_argument("--perfetto", default=None, metavar="PATH",
                   help="merged Chrome-trace JSON (trainer+lanes+server)")
    e.add_argument("--json", default=None, metavar="PATH",
                   help="full merged ledger as one JSON document")
    e.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
