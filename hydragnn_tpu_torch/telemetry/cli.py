"""``python -m hydragnn_tpu_torch.telemetry <events.jsonl>`` — the post-mortem
timeline renderer.

Counterpart of ``hydragnn_tpu/telemetry/cli.py`` (the port's own copy): it
renders a journal, a fleet's journals or a ledger written by either
package alike.

Turns a run's structured event journal (plus, when present, its
``trace.json``) into the human answer to "what happened": a chronological
event timeline, every elastic recovery reconstructed phase-by-phase from
its ``recovery_id``-correlated records (fault -> drain -> checkpoint ->
re-mesh -> resume), shed/failover totals, per-epoch throughput, and the
top aggregate spans. Pure stdlib + file reads — it must work on a login
node over the logs of a crashed job.

Two subcommands ride the same entry point:

``python -m hydragnn_tpu_torch.telemetry fleet <dir...>`` merges the journals
of a router process and its N replica log dirs into ONE cross-process
timeline — records are grouped by the ``request_id`` the trace-context
propagation layer (``telemetry/propagation.py``) carried over the wire,
ordered by ``(t_wall, seq)`` within a request, and labeled with the
source dir they came from. ``--trace-out`` additionally merges every
dir's ``trace.json`` into one perfetto-loadable file with a distinct
``pid`` (and a ``process_name`` metadata record) per source. Absent or
torn journals/traces are tolerated per dir, never fatal for the merge.

``python -m hydragnn_tpu_torch.telemetry ledger <current> [--baseline <base>]``
is the cost observatory's regression sentinel: without a baseline it
renders a ``ledger.json`` (``telemetry/ledger.py``); with one it diffs
the two and exits nonzero when any shared executable's flops /
bytes-accessed / peak-bytes inflated beyond ``--tolerance``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

from .journal import read_journal


def _fmt_t(rec: dict, t0: float) -> str:
    return f"+{max(rec.get('t_wall', t0) - t0, 0.0):9.3f}s"


def _fields(rec: dict, skip=("kind", "t_wall", "seq", "run_id")) -> str:
    parts = []
    for key in sorted(rec):
        if key in skip:
            continue
        value = rec[key]
        if isinstance(value, float):
            value = round(value, 6)
        parts.append(f"{key}={value}")
    return " ".join(parts)


def render_timeline(records: list[dict], limit: int = 200) -> str:
    if not records:
        return "timeline: no records"
    t0 = records[0].get("t_wall", 0.0)
    lines = [f"timeline ({len(records)} records):"]
    shown = records if len(records) <= limit else records[-limit:]
    if len(records) > limit:
        lines.append(f"  ... {len(records) - limit} earlier records elided "
                     "(--full shows everything)")
    for rec in shown:
        lines.append(
            f"  {_fmt_t(rec, t0)}  {rec.get('kind', '?'):<18} {_fields(rec)}"
        )
    return "\n".join(lines)


def render_recoveries(records: list[dict]) -> str:
    by_id: dict = defaultdict(list)
    for rec in records:
        rid = rec.get("recovery_id")
        if rid is not None:
            by_id[rid].append(rec)
    if not by_id:
        return "recoveries: none"
    lines = [f"recoveries ({len(by_id)}):"]
    for rid in sorted(by_id):
        phase_recs = by_id[rid]
        t0 = phase_recs[0].get("t_wall", 0.0)
        summary = next(
            (r for r in phase_recs if r.get("kind") == "recovery"), None
        )
        head = f"  {rid}:"
        if summary is not None:
            head += (
                f" mode={summary.get('mode')} "
                f"recovery_ms={round(float(summary.get('recovery_ms', 0)), 1)} "
                f"faults={summary.get('faults')}"
            )
        lines.append(head)
        for rec in phase_recs:
            kind = rec.get("kind")
            if kind == "recovery_phase":
                what = f"phase {rec.get('phase')}"
                if rec.get("detail"):
                    what += f" ({rec['detail']})"
            elif kind == "recovery":
                continue  # already on the header line
            else:
                what = f"{kind} {_fields(rec, skip=('kind', 't_wall', 'seq', 'run_id', 'recovery_id'))}"
            lines.append(f"    {_fmt_t(rec, t0)}  {what}")
    return "\n".join(lines)


def render_epochs(records: list[dict]) -> str:
    epochs = [r for r in records if r.get("kind") == "epoch"]
    if not epochs:
        return "epochs: none recorded"
    lines = ["epoch throughput:"]
    for rec in epochs:
        dur = float(rec.get("duration_s") or 0.0)
        raw = rec.get("raw_batches")
        rate = (
            f"{raw / dur:8.1f} batches/s" if raw and dur > 0 else "        -"
        )
        loss = rec.get("train_loss")
        loss_s = f"{loss:.6f}" if isinstance(loss, (int, float)) else "nan"
        lines.append(
            f"  epoch {rec.get('epoch', '?'):>4}: loss {loss_s}  "
            f"{dur:7.2f}s  {rate}"
            + (f"  val {rec['val_loss']:.6f}"
               if isinstance(rec.get("val_loss"), (int, float)) else "")
        )
    return "\n".join(lines)


def render_sheds(records: list[dict]) -> str:
    sheds = [r for r in records if r.get("kind") == "shed"]
    fails = [r for r in records if r.get("kind") == "failover"]
    if not sheds and not fails:
        return "sheds/failovers: none"
    by_reason: dict = defaultdict(int)
    for rec in sheds:
        key = (rec.get("model") or rec.get("class") or "?", rec.get("reason", "?"))
        by_reason[key] += 1
    lines = [f"sheds ({len(sheds)}) / failovers ({len(fails)}):"]
    for (who, reason), n in sorted(by_reason.items()):
        lines.append(f"  shed {who} [{reason}]: {n}")
    for rec in fails:
        lines.append(
            f"  failover replica={rec.get('replica', rec.get('peer', '?'))} "
            f"error={rec.get('error', '?')}"
        )
    return "\n".join(lines)


def render_top_spans(trace_path: str | None, top: int = 10) -> str:
    if not trace_path or not os.path.exists(trace_path):
        return "top spans: no trace.json"
    try:
        with open(trace_path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        # a torn trace.json (killed mid-save) must not cost the report —
        # the journal sections still render
        return f"top spans: unreadable trace.json ({e})"
    # both Chrome trace forms load: the object form ({"traceEvents": [...]})
    # our writer emits, and the equally valid bare-array form
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        return "top spans: unreadable trace.json (unexpected shape)"
    agg: dict = defaultdict(lambda: [0, 0.0])
    for ev in events:
        if ev.get("ph") != "X":
            continue
        entry = agg[ev.get("name", "?")]
        entry[0] += 1
        entry[1] += float(ev.get("dur", 0.0)) / 1e6
    if not agg:
        return "top spans: trace has no complete events"
    lines = [f"top spans ({os.path.basename(trace_path)}):"]
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (count, total) in ranked:
        lines.append(
            f"  {name:<24} total {total:9.3f}s over {count:6d} span(s) "
            f"(avg {1e3 * total / max(count, 1):8.2f} ms)"
        )
    return "\n".join(lines)


def render_report(records: list[dict], trace_path: str | None = None,
                  full: bool = False) -> str:
    run_id = next(
        (r["run_id"] for r in records if "run_id" in r), "<unknown>"
    )
    parts = [
        f"telemetry report — run {run_id}, {len(records)} journal record(s)",
        "",
        render_recoveries(records),
        "",
        render_epochs(records),
        "",
        render_sheds(records),
        "",
        render_top_spans(trace_path),
        "",
        render_timeline(records, limit=10**9 if full else 200),
    ]
    return "\n".join(parts)


# -- fleet: cross-process journal + trace merge -------------------------------


def _events_path(target: str) -> str:
    """A log dir resolves to its ``events.jsonl``; a file path is itself."""
    if os.path.isdir(target):
        return os.path.join(target, "events.jsonl")
    return target


def _source_label(target: str) -> str:
    """A short human label for a merge source: the log dir's basename."""
    if os.path.isdir(target):
        return os.path.basename(os.path.normpath(target)) or target
    parent = os.path.basename(os.path.dirname(os.path.abspath(target)))
    return parent or os.path.basename(target)


def load_fleet(targets: list[str]) -> tuple[list[dict], list[str]]:
    """Read every source's journal, tagging each record with the source
    label under ``_source``. Missing or empty journals produce a warning
    line (returned, not printed) instead of failing the merge — one dead
    replica must not hide the rest of the fleet."""
    tagged: list[dict] = []
    warnings: list[str] = []
    for target in targets:
        path = _events_path(target)
        label = _source_label(target)
        if not os.path.exists(path):
            warnings.append(f"warning: no events journal at {path}")
            continue
        records = read_journal(path)
        if not records:
            warnings.append(f"warning: empty events journal at {path}")
            continue
        for rec in records:
            rec = dict(rec)
            rec["_source"] = label
            tagged.append(rec)
    return tagged, warnings


def render_fleet_requests(tagged: list[dict]) -> str:
    """The cross-process view: every record sharing a ``request_id`` —
    regardless of which process journal it came from — renders as one
    ordered per-request timeline (order: ``(t_wall, seq)``)."""
    by_rid: dict = defaultdict(list)
    for rec in tagged:
        rid = rec.get("request_id")
        if rid is not None:
            by_rid[rid].append(rec)
    if not by_rid:
        return ("requests: no request_id-correlated records (was "
                "HYDRAGNN_TRACE_PROPAGATE off?)")
    # requests in arrival order (earliest record wins)
    order = sorted(
        by_rid, key=lambda rid: min(r.get("t_wall", 0.0) for r in by_rid[rid])
    )
    lines = [f"requests ({len(by_rid)}):"]
    for rid in order:
        recs = sorted(
            by_rid[rid],
            key=lambda r: (r.get("t_wall", 0.0), r.get("seq", 0)),
        )
        t0 = recs[0].get("t_wall", 0.0)
        sources = []
        for rec in recs:
            if rec["_source"] not in sources:
                sources.append(rec["_source"])
        lines.append(f"  {rid} ({len(recs)} records across "
                     f"{len(sources)} process(es): {', '.join(sources)})")
        for rec in recs:
            lines.append(
                f"    {_fmt_t(rec, t0)}  [{rec['_source']:<14}] "
                f"{rec.get('kind', '?'):<16} "
                f"{_fields(rec, skip=('kind', 't_wall', 'seq', 'run_id', 'request_id', '_source'))}"
            )
    return "\n".join(lines)


def render_fleet_timeline(tagged: list[dict], limit: int = 500) -> str:
    """Every record from every source on one wall-clock axis."""
    if not tagged:
        return "fleet timeline: no records"
    recs = sorted(
        tagged, key=lambda r: (r.get("t_wall", 0.0), r.get("seq", 0))
    )
    t0 = recs[0].get("t_wall", 0.0)
    n_src = len({r["_source"] for r in recs})
    lines = [f"fleet timeline ({len(recs)} records from {n_src} source(s)):"]
    shown = recs if len(recs) <= limit else recs[-limit:]
    if len(recs) > limit:
        lines.append(f"  ... {len(recs) - limit} earlier records elided")
    for rec in shown:
        rid = rec.get("request_id")
        rid_s = f" rid={str(rid)[:8]}" if rid is not None else ""
        lines.append(
            f"  {_fmt_t(rec, t0)}  [{rec['_source']:<14}] "
            f"{rec.get('kind', '?'):<16}{rid_s} "
            f"{_fields(rec, skip=('kind', 't_wall', 'seq', 'run_id', 'request_id', '_source'))}"
        )
    return "\n".join(lines)


def merge_fleet_traces(targets: list[str], out_path: str) -> tuple[str | None, list[str]]:
    """Merge every source dir's ``trace.json`` into one Chrome-trace file,
    remapping each source onto a distinct ``pid`` (with a ``process_name``
    metadata record carrying the source label) so perfetto renders the
    fleet as parallel process tracks. Absent or torn traces are skipped
    with a warning. Returns ``(written_path_or_None, warnings)``."""
    merged: list[dict] = []
    warnings: list[str] = []
    n_sources = 0
    for i, target in enumerate(targets):
        trace_path = (
            os.path.join(target, "trace.json") if os.path.isdir(target)
            else os.path.join(os.path.dirname(os.path.abspath(target)),
                              "trace.json")
        )
        label = _source_label(target)
        if not os.path.exists(trace_path):
            warnings.append(f"warning: no trace.json at {trace_path}")
            continue
        try:
            with open(trace_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            warnings.append(f"warning: unreadable trace.json at "
                            f"{trace_path} ({e})")
            continue
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        if not isinstance(events, list):
            warnings.append(f"warning: unexpected trace shape at {trace_path}")
            continue
        n_sources += 1
        merged.append({"ph": "M", "name": "process_name", "pid": i, "tid": 0,
                       "args": {"name": label}})
        for ev in events:
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev["pid"] = i
            merged.append(ev)
    if n_sources == 0:
        return None, warnings
    doc = {"traceEvents": merged, "displayTimeUnit": "ms"}
    tmp = f"{out_path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return out_path, warnings


def fleet_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hydragnn_tpu_torch.telemetry fleet",
        description="Merge the journals (and traces) of a router + N "
                    "replica log dirs into one cross-process, "
                    "request_id-correlated timeline.",
    )
    parser.add_argument(
        "dirs", nargs="+",
        help="log dirs (or events.jsonl paths) to merge — the router's "
             "and each replica's",
    )
    parser.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="also merge every dir's trace.json into PATH with a distinct "
             "pid per source (perfetto-loadable)",
    )
    parser.add_argument(
        "--limit", type=int, default=500,
        help="cap on flat-timeline records (default 500)",
    )
    args = parser.parse_args(argv)
    tagged, warnings = load_fleet(args.dirs)
    for line in warnings:
        print(line, file=sys.stderr)
    if not tagged:
        print(f"error: no journal records in any of: {', '.join(args.dirs)}",
              file=sys.stderr)
        return 2
    parts = [
        f"fleet report — {len(tagged)} record(s) from "
        f"{len(args.dirs)} source(s)",
        "",
        render_fleet_requests(tagged),
        "",
        render_fleet_timeline(tagged, limit=args.limit),
    ]
    if args.trace_out:
        written, trace_warnings = merge_fleet_traces(args.dirs, args.trace_out)
        for line in trace_warnings:
            print(line, file=sys.stderr)
        parts += ["", f"merged trace: {written or 'no usable trace.json'}"]
    try:
        print("\n".join(parts))
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except OSError:
            pass
    return 0


# -- ledger: cost-observatory render + regression sentinel --------------------


def render_ledger(doc: dict) -> str:
    entries = doc.get("entries", [])
    lines = [
        f"cost ledger — schema {doc.get('schema', '?')}, backend "
        f"{doc.get('backend', '?')}, {len(entries)} entr(ies)",
    ]
    lowerings = doc.get("lowerings") or {}
    if lowerings:
        lines.append(
            "lowerings: " + " ".join(
                f"{k}={lowerings[k]}" for k in sorted(lowerings))
        )
    for entry in entries:
        head = (f"  {entry.get('model', '?')} | kind={entry.get('kind', '?')} "
                f"| bucket={entry.get('bucket')} "
                f"| {entry.get('precision', '?')}")
        lines.append(head)
        cost_bits = []
        for key in ("flops", "bytes_accessed", "peak_bytes", "temp_bytes",
                    "generated_code_bytes", "compile_s"):
            value = entry.get(key)
            if isinstance(value, (int, float)):
                cost_bits.append(f"{key}={value:g}")
        if cost_bits:
            lines.append("    " + " ".join(cost_bits))
    return "\n".join(lines)


def render_ledger_diff(result: dict) -> str:
    lines = [
        f"ledger diff — {result['compared']} shared entr(ies) compared, "
        f"tolerance {result['tolerance']:.1%}",
    ]
    for key in result["only_in_baseline"]:
        lines.append(f"  only in baseline: {key}")
    for key in result["only_in_current"]:
        lines.append(f"  only in current:  {key}")
    for delta in result["improvements"]:
        lines.append(
            f"  improved  {delta['key']} {delta['metric']}: "
            f"{delta['baseline']:g} -> {delta['current']:g} "
            f"(x{delta['ratio']:.4f})"
        )
    for delta in result["regressions"]:
        lines.append(
            f"  REGRESSED {delta['key']} {delta['metric']}: "
            f"{delta['baseline']:g} -> {delta['current']:g} "
            f"(x{delta['ratio']:.4f})"
        )
    lines.append(
        "ledger diff: OK" if result["ok"]
        else f"ledger diff: FAIL — {len(result['regressions'])} cost "
             f"regression(s) beyond tolerance"
    )
    return "\n".join(lines)


def _load_ledger(path: str) -> dict:
    if os.path.isdir(path):
        path = os.path.join(path, "ledger.json")
    from . import ledger as _ledger

    return _ledger.load(path)


def ledger_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hydragnn_tpu_torch.telemetry ledger",
        description="Render a cost ledger, or diff it against a baseline "
                    "and fail on compiled-cost inflation beyond tolerance.",
    )
    parser.add_argument(
        "current",
        help="path to a ledger.json (or a run log dir containing one)",
    )
    parser.add_argument(
        "--baseline", default=None,
        help="baseline ledger.json to diff against (regression sentinel "
             "mode: exit 1 on cost inflation beyond --tolerance)",
    )
    parser.add_argument(
        "--tolerance", type=float, default=0.02,
        help="relative inflation tolerance for the diff (default 0.02)",
    )
    args = parser.parse_args(argv)
    try:
        current = _load_ledger(args.current)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: cannot read ledger at {args.current}: {e}",
              file=sys.stderr)
        return 2
    if args.baseline is None:
        print(render_ledger(current))
        return 0
    try:
        baseline = _load_ledger(args.baseline)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: cannot read baseline ledger at {args.baseline}: {e}",
              file=sys.stderr)
        return 2
    from . import ledger as _ledger

    result = _ledger.diff(baseline, current, tolerance=args.tolerance)
    print(render_ledger_diff(result))
    return 0 if result["ok"] else 1


# -- entry point --------------------------------------------------------------


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # subcommand dispatch rides in front of the legacy positional form:
    # `... telemetry <events.jsonl>` keeps working unchanged
    if argv and argv[0] == "fleet":
        return fleet_main(argv[1:])
    if argv and argv[0] == "ledger":
        return ledger_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m hydragnn_tpu_torch.telemetry",
        description="Render a run's events.jsonl (and trace.json) into a "
                    "human timeline: recoveries, sheds, epoch throughput, "
                    "top spans. Subcommands: `fleet <dir...>` merges a "
                    "router + replica journals into one cross-process "
                    "timeline; `ledger <current> [--baseline <base>]` "
                    "renders/diffs the compiled-cost ledger.",
    )
    parser.add_argument(
        "events",
        help="path to an events.jsonl, or a run log dir containing one",
    )
    parser.add_argument(
        "--trace", default=None,
        help="trace.json for the top-spans section (default: the "
             "events file's sibling trace.json, when present)",
    )
    parser.add_argument(
        "--full", action="store_true",
        help="print every timeline record (default caps at 200)",
    )
    args = parser.parse_args(argv)
    events_path = _events_path(args.events)
    if not os.path.exists(events_path):
        # operator-facing miss (wrong dir, crashed-before-first-write run):
        # one line naming the path, no usage dump, no traceback
        print(f"error: no events journal at {events_path}", file=sys.stderr)
        return 2
    trace_path = args.trace
    if trace_path is None:
        sibling = os.path.join(os.path.dirname(events_path), "trace.json")
        trace_path = sibling if os.path.exists(sibling) else None
    records = read_journal(events_path)
    if not records:
        print(f"error: empty events journal at {events_path}",
              file=sys.stderr)
        return 2
    try:
        print(render_report(records, trace_path=trace_path, full=args.full))
    except BrokenPipeError:
        # `... | head` closed the pipe: normal operator behavior, not an
        # error worth a traceback
        try:
            sys.stdout.close()
        except OSError:
            pass
    return 0


__all__ = [
    "fleet_main",
    "ledger_main",
    "load_fleet",
    "main",
    "merge_fleet_traces",
    "render_epochs",
    "render_fleet_requests",
    "render_fleet_timeline",
    "render_ledger",
    "render_ledger_diff",
    "render_recoveries",
    "render_report",
    "render_sheds",
    "render_timeline",
    "render_top_spans",
]
