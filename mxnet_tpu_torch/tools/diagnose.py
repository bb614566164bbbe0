"""Environment diagnosis and telemetry rendering (counterpart of
``mxnet_tpu/tools/diagnose.py``; parity: tools/diagnose.py, minus the
network-reachability section — the equivalent signal is device
reachability: a short-timeout subprocess probe of the CUDA device).

Run: ``python -m mxnet_tpu_torch.tools.diagnose``.

Telemetry mode: ``python -m mxnet_tpu_torch.tools.diagnose <run>.jsonl``
reads a telemetry JSONL sink back into human tables — step-time
percentiles, per-phase breakdown, goodput, memory watermarks, the
Decode, Prefix cache, Router and Usage tables with their
reconciliation lines, and the Alerts table — plus every other table
the JAX package's sinks carry (compile log, utilization, checkpoints,
serving, bucketing, gradient sync, per-link comms), so a sink from
either package renders the same. A truncated trailing line (a run
killed mid-append) is skipped with a one-line warning; the rest of the
report renders.

Fleet mode: pointing diagnose at a DIRECTORY (or a shell glob) of
per-rank/per-worker sinks renders the cross-rank report instead — a
skew table plus a fleet serving rollup that joins router records
against replica records across sinks (``dispatched == admitted +
shed``) and reconciles flight-recorder bundles (``flightrec``) against
the ``replica_lost`` alerts that triggered them. A torn sink or bundle
becomes a counted WARNING line, never an abort. ``--format json``
mirrors every table — single file or fleet — as structured records.

Only the environment sections differ from the JAX tool's: they report
Python, torch, CUDA and the card's name. For the same input files the
telemetry, fleet, usage and bundle modes print exactly what the JAX
tool prints.
"""
from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import platform
import re
import subprocess
import sys


def diagnose_python():
    print("----------Python Info----------")
    print("Version      :", platform.python_version())
    print("Compiler     :", platform.python_compiler())
    print("Build        :", platform.python_build())
    print("Arch         :", platform.architecture())


def diagnose_os():
    print("----------System Info----------")
    print("Platform     :", platform.platform())
    print("system       :", platform.system())
    print("node         :", platform.node())
    print("release      :", platform.release())
    print("version      :", platform.version())


def diagnose_hardware():
    print("----------Hardware Info----------")
    print("machine      :", platform.machine())
    print("processor    :", platform.processor())
    if sys.platform.startswith("linux"):
        try:
            out = subprocess.run(["lscpu"], capture_output=True,
                                 text=True, timeout=10)
            print(out.stdout.strip())
        except Exception:
            pass


def diagnose_mxnet():
    print("----------MXNet-TPU Info----------")
    import mxnet_tpu_torch as mx
    import torch
    print("Version      :", getattr(mx, "__version__", "dev"))
    print("Directory    :", os.path.dirname(mx.__file__))
    print("torch        :", torch.__version__)
    print("CUDA         :", torch.version.cuda)
    from .. import envs as _envs
    declared = _envs.snapshot()
    knobs = {k: v for k, v in os.environ.items()
             if k.startswith(("MXNET_", "CUDA_", "TORCH_"))}
    for k in sorted(knobs):
        # a set-but-undeclared MXNET_* is almost always a typo'd
        # knob nothing will ever read — this table is where the
        # operator finds out, so it must not be hidden
        tag = "" if not k.startswith("MXNET_") or k in declared \
            else "  (undeclared — typo? see mxnet_tpu_torch/envs.py)"
        print("env %-24s: %s%s" % (k, knobs[k], tag))


def diagnose_backend(timeout):
    """Device reachability (the zero-egress analogue of the
    reference's URL tests): the CUDA devices' names, queried in a
    subprocess so a hung device cannot hang the diagnosis."""
    print("----------Backend Reachability----------")
    code = ("import torch; n = torch.cuda.device_count(); "
            "print([torch.cuda.get_device_name(i) for i in range(n)])")
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=timeout)
        if out.returncode == 0:
            print("devices      :", out.stdout.strip().splitlines()[-1])
        else:
            print("backend ERROR:", (out.stderr or "").strip()[-400:])
    except subprocess.TimeoutExpired:
        print("backend HUNG : the CUDA device query did not answer "
              "within %ds — device attachment is broken" % timeout)


# ---------------------------------------------------------------------------
# telemetry JSONL mode
# ---------------------------------------------------------------------------

def read_telemetry(path):
    """Parse a mxnet_tpu.telemetry JSONL sink. Unparseable lines —
    including a truncated final line from a run killed mid-append, or
    a line whose JSON prefix parses to a non-record scalar — are
    counted into ``skipped_lines`` and skipped, never fatal: the
    report renders everything else and warns once. A sink holding
    several runs (consecutive fits appending to the same
    MXNET_TELEMETRY_FILE) yields the LAST run."""
    out = {"run": None, "steps": [], "memory": [], "compiles": [],
           "utilization": [], "checkpoints": [], "serving": [],
           "decode": [], "router": [], "prefix_cache": [],
           "bucketing": [], "alerts": [], "usage": [],
           "usage_records": [],
           "loss_scale": [], "breakdown": None, "summary": None}
    skipped = 0
    unknown = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if not isinstance(rec, dict):
                # a kill mid-append can strand a prefix that is
                # itself valid JSON (a bare number, null) — still
                # not a record
                skipped += 1
                continue
            kind = rec.get("type")
            if kind == "run_start":
                out = {"run": rec, "steps": [], "memory": [],
                       "compiles": [], "utilization": [],
                       "checkpoints": [], "serving": [],
                       "decode": [], "router": [],
                       "prefix_cache": [], "bucketing": [],
                       "alerts": [], "usage": [],
                       "usage_records": [], "loss_scale": [],
                       "breakdown": None, "summary": None}
                skipped = 0     # earlier runs' damage is not THIS
                                # run's — the warning describes the
                                # run being rendered
                unknown = {}
            elif kind == "step":
                out["steps"].append(rec)
            elif kind == "memory":
                out["memory"].append(rec)
            elif kind == "memory_breakdown":
                out["breakdown"] = rec      # watermarks: last is max
            elif kind == "compile":
                out["compiles"].append(rec)
            elif kind == "utilization":
                out["utilization"].append(rec)
            elif kind == "checkpoint":
                out["checkpoints"].append(rec)
            elif kind == "serving":
                out["serving"].append(rec)
            elif kind == "decode":
                out["decode"].append(rec)
            elif kind == "router":
                out["router"].append(rec)
            elif kind == "prefix_cache":
                out["prefix_cache"].append(rec)
            elif kind == "bucketing":
                out["bucketing"].append(rec)
            elif kind == "alert":
                out["alerts"].append(rec)
            elif kind == "loss_scale":
                out["loss_scale"].append(rec)
            elif kind == "usage":
                out["usage"].append(rec)
            elif kind == "usage_record":
                # one closed per-request ledger line (the
                # MXNET_METER_FILE format) — diagnose pointed straight
                # at a ledger renders the bill from these
                out["usage_records"].append(rec)
            elif kind == "summary":
                out["summary"] = rec
            else:
                # a record kind this diagnose does not know — written
                # by a NEWER sink. Count it per kind instead of
                # dropping it silently, so a version skew between
                # producer and reader is visible in the report.
                key = kind if isinstance(kind, str) else "?"
                unknown[key] = unknown.get(key, 0) + 1
    out["skipped_lines"] = skipped
    out["unknown_kinds"] = unknown
    return out


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return "%.1f %s" % (n, unit)
        n /= 1024.0


def _fmt_flops(n):
    for unit in ("FLOP", "KFLOP", "MFLOP", "GFLOP", "TFLOP"):
        if abs(n) < 1000.0 or unit == "TFLOP":
            return "%.2f %s" % (n, unit)
        n /= 1000.0


def format_telemetry(tel):
    """Render the parsed telemetry run as the human tables (step-time
    percentiles over ALL step records in the file, phases, goodput,
    memory watermarks, per-key comms)."""
    from ..telemetry import percentile
    run = tel.get("run") or {}
    summary = tel.get("summary") or {}
    steps = tel.get("steps") or []
    lines = ["----------Telemetry Run----------",
             "run_id       : %s" % (run.get("run_id") or
                                    summary.get("run_id") or "?")]
    if run.get("meta"):
        lines.append("meta         : %s" % json.dumps(run["meta"]))
    if tel.get("skipped_lines"):
        lines.append("WARNING      : skipped %d unparseable line(s) — "
                     "a killed run strands at most one truncated "
                     "trailing record; the rest renders below"
                     % tel["skipped_lines"])
    if tel.get("unknown_kinds"):
        unk = tel["unknown_kinds"]
        lines.append("WARNING      : ignored %d record(s) of unknown "
                     "kind (%s) — the sink was written by a newer "
                     "mxnet_tpu than this diagnose understands; "
                     "everything else renders below"
                     % (sum(unk.values()),
                        ", ".join("%s x%d" % kv
                                  for kv in sorted(unk.items()))))

    compiles = tel.get("compiles") or []
    lines.append("----------Step time----------")
    durs = [s["dur_ms"] for s in steps if s.get("dur_ms") is not None]
    if durs:
        lines.append("steps        : %d" % len(durs))
        lines.append("mean(ms)     : %.3f" % (sum(durs) / len(durs)))
        for q in (50, 90, 99):
            lines.append("p%-2d(ms)      : %.3f" % (q,
                                                    percentile(durs, q)))
        lines.append("max(ms)      : %.3f" % max(durs))
    elif compiles:
        # a sink with compiles but no steps is not a broken file — the
        # run crashed before step 1, or was a compile-only run
        lines.append("no step records — run recorded %d compile(s) "
                     "but no steps (crashed before step 1, or a "
                     "compile-only run)" % len(compiles))
    else:
        lines.append("no step records")

    # the summary's totals are whole-run truth (they include phases
    # that run BETWEEN steps — epoch-end checkpoint/eval); summing the
    # step records is the fallback for a run that died before stop()
    totals = dict(summary.get("phases_ms") or {})
    if not totals:
        for s in steps:
            for phase, ms in (s.get("phases_ms") or {}).items():
                totals[phase] = totals.get(phase, 0.0) + ms
    if totals:
        lines.append("----------Phases----------")
        whole = sum(totals.values()) or 1.0
        for phase in sorted(totals, key=totals.get, reverse=True):
            lines.append("%-12s : %12.3f ms  (%5.1f%%)"
                         % (phase, totals[phase],
                            100.0 * totals[phase] / whole))

    # -- compile log (mxnet_tpu.compile_watch) --------------------------
    sum_compile = summary.get("compile") or {}
    if compiles or sum_compile:
        lines.append("----------Compilation----------")
        progs = {}
        for c in compiles:
            p = progs.setdefault(c.get("program", "?"),
                                 {"count": 0, "ms": 0.0, "causes": {},
                                  "churn": {}})
            p["count"] += 1
            p["ms"] += c.get("dur_ms", 0.0)
            cause = (c.get("cause") or "?").split(" ", 1)[0]
            p["causes"][cause] = p["causes"].get(cause, 0) + 1
            for arg in c.get("changed", ()):
                p["churn"][arg] = p["churn"].get(arg, 0) + 1
        if not progs:
            # compile records flushed out of an earlier file segment:
            # fall back to the summary's per-program table
            for name, s in (sum_compile.get("programs") or {}).items():
                progs[name] = {"count": s.get("count", 0),
                               "ms": s.get("total_s", 0.0) * 1e3,
                               "causes": dict(s.get("causes") or {}),
                               "churn": dict(s.get("churn") or {})}
        total_ms = 0.0
        lines.append("%-28s %6s %10s  %s"
                     % ("program", "count", "time(ms)",
                        "causes [churning arg]"))
        for name in sorted(progs, key=lambda n: -progs[n]["ms"]):
            p = progs[name]
            total_ms += p["ms"]
            causes = ",".join("%s:%d" % kv
                              for kv in sorted(p["causes"].items()))
            if p["churn"]:
                causes += " [%s]" % max(p["churn"], key=p["churn"].get)
            lines.append("%-28s %6d %10.1f  %s"
                         % (name[:28], p["count"], p["ms"], causes))
        lines.append("%-28s %6d %10.1f" % (
            "TOTAL", sum(p["count"] for p in progs.values()), total_ms))
        for s in sum_compile.get("storms") or []:
            lines.append("RECOMPILE STORM: %s compiled %sx within %s "
                         "steps — churning argument '%s'"
                         % (s.get("program"), s.get("compiles"),
                            s.get("window_steps"), s.get("arg")))
        fused = {k: v for k, v in (summary.get("counters") or {}).items()
                 if k.startswith("fused_step")}
        if fused:
            lines.append("fused-step cache: " + ", ".join(
                "%s=%s" % (k[len("fused_step_"):],
                           round(v, 1) if isinstance(v, float) else v)
                for k, v in sorted(fused.items())))
        cache = sum_compile.get("cache") or {}
        if cache:
            lines.append(
                "compile-cache: %d hit(s) / %d miss(es), "
                "%s read / %s written, %d entr%s (%s on disk), "
                "%d evicted, %d error(s)"
                % (cache.get("hits", 0), cache.get("misses", 0),
                   _fmt_bytes(cache.get("bytes_read", 0)),
                   _fmt_bytes(cache.get("bytes_written", 0)),
                   cache.get("entries", 0),
                   "y" if cache.get("entries", 0) == 1 else "ies",
                   _fmt_bytes(cache.get("size_bytes", 0)),
                   cache.get("evictions", 0), cache.get("errors", 0)))

    # -- hardware utilization (MFU / memory bandwidth) ------------------
    utils = tel.get("utilization") or []
    sum_util = summary.get("utilization") or {}
    if utils or sum_util:
        lines.append("----------Utilization----------")
        if sum_util.get("device_kind"):
            lines.append("device       : %s x%d (peak %.1f TFLOP/s, "
                         "%.0f GB/s each)"
                         % (sum_util["device_kind"],
                            sum_util.get("n_devices", 1),
                            sum_util.get("peak_flops", 0.0) / 1e12,
                            sum_util.get("peak_bw", 0.0) / 1e9))
        mfus = [u["mfu"] for u in utils if u.get("mfu") is not None]
        if not mfus and sum_util.get("mfu"):
            m = sum_util["mfu"]
            lines.append("MFU p50      : %8.3f %%" % (100 * m["p50"]))
            lines.append("MFU p90      : %8.3f %%" % (100 * m["p90"]))
        elif mfus:
            lines.append("MFU p50      : %8.3f %%"
                         % (100 * percentile(mfus, 50)))
            lines.append("MFU p90      : %8.3f %%"
                         % (100 * percentile(mfus, 90)))
        bwus = [u["bw_util"] for u in utils
                if u.get("bw_util") is not None]
        if bwus:
            lines.append("HBM BW p50   : %8.3f %%"
                         % (100 * percentile(bwus, 50)))
        flops = [u.get("flops", 0.0) for u in utils]
        fdurs = [u.get("dur_ms") for u in utils
                 if u.get("dur_ms") and u.get("flops")]
        if any(flops):
            lines.append("flops/step   : %s (dispatched, XLA cost "
                         "model)" % _fmt_flops(
                             sum(flops) / max(1, len(flops))))
            if fdurs:
                tf = sum(u["flops"] for u in utils
                         if u.get("dur_ms") and u.get("flops"))
                lines.append("sustained    : %s/s"
                             % _fmt_flops(tf / (sum(fdurs) / 1e3)))

    # -- checkpoint saves (mxnet_tpu.checkpoint) ------------------------
    ckpts = tel.get("checkpoints") or []
    sum_ckpt = summary.get("checkpoint") or {}
    if ckpts or sum_ckpt:
        lines.append("----------Checkpoints----------")
        lines.append("%5s %4s %12s %10s %10s %10s %7s"
                     % ("epoch", "ok", "bytes", "total(ms)",
                        "block(ms)", "async(ms)", "shards"))
        for c in ckpts:
            lines.append("%5s %4s %12d %10.1f %10.1f %10.1f %7s"
                         % (c.get("epoch", "?"),
                            "yes" if c.get("ok") else "NO",
                            c.get("bytes", 0) or 0,
                            c.get("total_ms", 0.0) or 0.0,
                            c.get("blocking_ms", 0.0) or 0.0,
                            c.get("async_ms", 0.0) or 0.0,
                            c.get("shards", "-")))
        blocking = sum_ckpt.get("blocking_ms") if sum_ckpt else None
        if blocking is None:
            blocking = sum(c.get("blocking_ms", 0.0) or 0.0
                           for c in ckpts)
        async_ms = sum_ckpt.get("async_ms") if sum_ckpt else None
        if async_ms is None:
            async_ms = sum(c.get("async_ms", 0.0) or 0.0 for c in ckpts)
        total = blocking + async_ms
        if total > 0:
            lines.append("async share  : %.1f%% of %.1f ms save work "
                         "ran off the training thread (blocking "
                         "%.1f ms)" % (100.0 * async_ms / total, total,
                                       blocking))
        failures = sum_ckpt.get("failures",
                                sum(1 for c in ckpts
                                    if not c.get("ok")))
        if failures:
            lines.append("failed saves : %d (training continued; the "
                         "previous good epoch stays the resume point)"
                         % failures)
        last_good = sum_ckpt.get("last_good_epoch")
        if last_good is None and ckpts:
            last_good = ckpts[-1].get("last_good_epoch")
        lines.append("last good    : epoch %s" % (last_good
                                                  if last_good is not None
                                                  else "none"))

    # -- inference serving (mxnet_tpu.serving) --------------------------
    servings = tel.get("serving") or []
    # records are cumulative snapshots: the last one is the run's truth
    sv = servings[-1] if servings else (summary.get("serving") or {})
    if sv:
        lines.append("----------Serving----------")
        lines.append("requests     : %d submitted (completed %d, shed "
                     "%d, timeout %d, errors %d)"
                     % (sv.get("requests", 0), sv.get("completed", 0),
                        sv.get("shed", 0), sv.get("timeouts", 0),
                        sv.get("errors", 0)))
        lat = sv.get("latency_ms") or {}
        if lat:
            lines.append("latency(ms)  : p50 %.3f  p90 %.3f  p99 %.3f "
                         " max %.3f"
                         % (lat.get("p50", 0.0), lat.get("p90", 0.0),
                            lat.get("p99", 0.0), lat.get("max", 0.0)))
        lines.append("throughput   : %.2f req/s over %d batch(es)"
                     % (sv.get("rps", 0.0), sv.get("batches", 0)))
        occ = sv.get("occupancy")
        if occ is not None:
            from ..bucketing.ladder import bucket_sort_key
            per_bucket = " ".join(
                "b%s:%s" % kv
                for kv in sorted((sv.get("buckets") or {}).items(),
                                 key=lambda kv: bucket_sort_key(kv[0])))
            lines.append("occupancy    : %.1f%% mean of bucket slots "
                         "(%s)" % (100.0 * occ, per_bucket or "-"))
        lines.append("queue depth  : peak %d of bound %d (ladder %s)"
                     % (sv.get("queue_peak", 0),
                        sv.get("max_queue", 0),
                        sv.get("ladder", [])))
        rb = sv.get("replica_batches") or []
        if sv.get("replicas", 1) > 1:
            lines.append("replicas     : %d (batches per replica: %s — "
                         "least-outstanding dispatch)"
                         % (sv["replicas"],
                            ", ".join(str(b) for b in rb)))
        if sv.get("dispatch_faults"):
            lines.append("faults       : %d injected dispatch fault(s) "
                         "survived" % sv["dispatch_faults"])
        shed_pri = sv.get("shed_by_priority") or {}
        if shed_pri:
            lines.append("shed/prio    : %s (lowest class sheds "
                         "first)"
                         % " ".join("p%s:%s" % kv_
                                    for kv_ in sorted(
                                        shed_pri.items())))

    # -- dynamic loss scale (fault.scale_backoff under AMP) --------------
    ls_recs = tel.get("loss_scale") or []
    if ls_recs:
        lines.append("----------Loss Scale----------")
        shown = ls_recs[-12:]
        traj = "%g" % shown[0].get("prev", 0)
        for r in shown:
            traj += " -> %g (%s)" % (r.get("scale", 0),
                                     r.get("cause") or "?")
        prefix = "(+%d earlier) " % (len(ls_recs) - len(shown)) \
            if len(ls_recs) > len(shown) else ""
        lines.append("trajectory   : %s%s" % (prefix, traj))
        n_back = sum(1 for r in ls_recs
                     if r.get("cause") == "backoff")
        lines.append("changes      : %d backoff(s), %d regrow(s); "
                     "final scale %g — a scale pinned at 1.0 means a "
                     "numerics problem, not an overflow problem"
                     % (n_back, len(ls_recs) - n_back,
                        ls_recs[-1].get("scale", 0)))

    # -- autoregressive decode serving (serving.decode) -----------------
    dec_recs = tel.get("decode") or []
    # records are cumulative per server name: keep each name's last
    dec = {}
    for rec in dec_recs:
        dec[rec.get("name") or "default"] = rec
    if not dec:
        dec = dict(summary.get("decode") or {})
    if dec:
        lines.append("----------Decode----------")
        for name in sorted(dec):
            d = dec[name]
            lines.append("%-12s : %d request(s) (completed %d, "
                         "cancelled %d, timeout %d, shed %d, "
                         "preempted %d, errors %d)"
                         % (name[:12], d.get("requests", 0),
                            d.get("completed", 0),
                            d.get("cancelled", 0),
                            d.get("timeouts", 0), d.get("shed", 0),
                            d.get("preempted", 0), d.get("errors", 0)))
            frac = d.get("prefill_fraction")
            lines.append("  steps      : %d prefill + %d decode (%s "
                         "prefill share) — the continuous-batching "
                         "mix"
                         % (d.get("prefill_steps", 0),
                            d.get("decode_steps", 0),
                            "%.1f%%" % (100.0 * frac)
                            if frac is not None else "n/a"))
            lines.append("  tokens     : %d out at %.1f tokens/s"
                         % (d.get("tokens_out", 0),
                            d.get("tokens_per_sec", 0.0)))
            it = d.get("inter_token_ms") or {}
            if it:
                lines.append("  inter-token: p50 %.3f ms  p99 %.3f ms "
                             " max %.3f ms"
                             % (it.get("p50", 0.0), it.get("p99", 0.0),
                                it.get("max", 0.0)))
            tt = d.get("ttft_ms") or {}
            if tt:
                lines.append("  first token: p50 %.3f ms  p99 %.3f ms"
                             % (tt.get("p50", 0.0), tt.get("p99", 0.0)))
            kv = d.get("kv") or {}
            if kv:
                pages = kv.get("pages", 0) or 1
                dtype = kv.get("dtype") or "float32"
                lines.append("  kv pool    : %d/%d pages used (peak "
                             "%d, %.1f%%), %d evicted, page size %d, "
                             "dtype %s"
                             % (kv.get("used", 0), kv.get("pages", 0),
                                kv.get("peak_used", 0),
                                100.0 * kv.get("peak_used", 0) / pages,
                                kv.get("evicted", 0),
                                kv.get("page_size", 0), dtype))
            if d.get("swaps"):
                lines.append("  weights    : %d hot swap(s), serving "
                             "version %s (%d generation(s) alive)"
                             % (d.get("swaps", 0),
                                d.get("weight_version", "?"),
                                d.get("versions_alive", 1)))
            shed_pri = d.get("shed_by_priority") or {}
            if shed_pri:
                lines.append("  shed/prio  : %s"
                             % " ".join("p%s:%s" % kv_
                                        for kv_ in sorted(
                                            shed_pri.items())))

    # -- KV prefix cache (serving.kvcache page sharing) -----------------
    px_recs = tel.get("prefix_cache") or []
    # records are cumulative per server name: keep each name's last
    px = {}
    for rec in px_recs:
        px[rec.get("name") or "default"] = rec
    if not px:
        px = dict(summary.get("prefix_cache") or {})
    if px:
        lines.append("----------Prefix cache----------")
        for name in sorted(px):
            p = px[name]
            hits = p.get("hits", 0)
            total = hits + p.get("misses", 0)
            lines.append("%-12s : %d/%d prompt(s) hit (%.1f%%), %d "
                         "token(s) served from shared pages"
                         % (name[:12], hits, total,
                            100.0 * p.get("hit_rate", 0.0),
                            p.get("hit_tokens", 0)))
            lines.append("  saved      : %s of prefill K/V not "
                         "recomputed"
                         % _fmt_bytes(p.get("bytes_saved", 0)))
            pool = p.get("pool") or {}
            lines.append("  pages      : %d indexed, %d shared now, "
                         "%d cow split(s) (%d degraded), %d cold "
                         "entr(ies) evicted"
                         % (pool.get("entries", 0),
                            pool.get("shared_pages",
                                     p.get("shared_pages", 0)),
                            p.get("cow_splits", 0),
                            p.get("cow_degraded", 0),
                            pool.get("evicted", 0)))
            owners = p.get("owners") or {}
            for oname in sorted(owners):
                o = owners[oname]
                quota = o.get("quota")
                lines.append("  model %-6s: %d page(s) held%s, pool "
                             "priority %d"
                             % (oname[:6], o.get("used", 0),
                                " of %d quota" % quota
                                if quota else "",
                                o.get("priority", 0)))

    # -- fleet serving router (serving.router) --------------------------
    rt_recs = tel.get("router") or []
    # records are cumulative per router name: keep each name's last
    rt = {}
    for rec in rt_recs:
        rt[rec.get("name") or "default"] = rec
    if not rt:
        rt = dict(summary.get("router") or {})
    if rt:
        lines.append("----------Router----------")
        for name in sorted(rt):
            r = rt[name]
            lines.append("%-12s : %d session(s) (dispatched %d, "
                         "completed %d, failed %d, cancelled %d, "
                         "shed %d, timeout %d)"
                         % (name[:12], r.get("requests", 0),
                            r.get("dispatched", 0),
                            r.get("completed", 0), r.get("failed", 0),
                            r.get("cancelled", 0), r.get("shed", 0),
                            r.get("timeouts", 0)))
            reps = r.get("replicas") or []
            if reps:
                lines.append("  replicas   : %d up of %d — %s"
                             % (r.get("replicas_up", 0), len(reps),
                                " ".join(
                                    "%s:%s(out %s)"
                                    % (p.get("name", "?"),
                                       p.get("state", "?"),
                                       p.get("outstanding", 0))
                                    for p in reps)))
            lines.append("  failover   : %d replica(s) lost, %d "
                         "session(s) re-homed, %d token(s) replayed "
                         "by re-prefill%s"
                         % (r.get("replicas_lost", 0),
                            r.get("failovers", 0),
                            r.get("replay_tokens", 0),
                            " (%d from shared prefix pages)"
                            % r.get("replay_cached_tokens", 0)
                            if r.get("replay_cached_tokens") else ""))
            res = r.get("failover_resume_ms") or {}
            if res:
                lines.append("  resume     : p50 %.3f ms  p99 %.3f ms "
                             " max %.3f ms (loss detection -> first "
                             "resumed token)"
                             % (res.get("p50", 0.0),
                                res.get("p99", 0.0),
                                res.get("max", 0.0)))
            if r.get("drains") or r.get("drain_timeouts"):
                lines.append("  drains     : %d graceful (%d timed "
                             "out into failover)"
                             % (r.get("drains", 0),
                                r.get("drain_timeouts", 0)))
            for tname in sorted(r.get("tenants") or {}):
                t = (r.get("tenants") or {})[tname]
                lat = t.get("latency_ms") or {}
                lines.append("  tenant %-5s: w=%s rate=%s — %d "
                             "submitted, %d done, %d shed, %d "
                             "throttle(s)%s"
                             % (tname[:5], t.get("weight", 1.0),
                                t.get("rate", 0.0) or "inf",
                                t.get("submitted", 0),
                                t.get("completed", 0),
                                t.get("shed", 0),
                                t.get("throttled", 0),
                                ", p99 %.1f ms" % lat["p99"]
                                if lat else ""))
            if r.get("scale_up_signals") or r.get("scale_down_signals"):
                lines.append("  autoscale  : %d scale-up signal(s), "
                             "%d scale-down"
                             % (r.get("scale_up_signals", 0),
                                r.get("scale_down_signals", 0)))

    # -- usage metering & cost attribution (mxnet_tpu.metering) ---------
    usage = _usage_view(tel, summary)
    if usage:
        router_rec = next(iter(rt.values())) if len(rt) == 1 else None
        lines.append("----------Usage----------")
        for mname in sorted(usage):
            u = usage[mname]
            lines.append("%-12s : %d request(s) metered (closed %d, "
                         "open %d%s)%s"
                         % (mname[:12], u.get("admitted", 0),
                            u.get("closed", 0), u.get("open", 0),
                            ", dispatched %d" % u["dispatched"]
                            if u.get("dispatched") is not None else "",
                            " — synthesized from raw ledger lines"
                            if u.get("synthesized") else ""))
            for tname in sorted(u.get("tenants") or {}):
                t = (u.get("tenants") or {})[tname]
                ocs = " ".join("%s:%d" % kv for kv in
                               sorted((t.get("outcomes") or {})
                                      .items()))
                lines.append("  tenant %-5s: %d+%d tok (prompt+gen), "
                             "%s, %.3f page*s, %d tok credited, %d "
                             "replayed%s"
                             % (tname[:5],
                                t.get("prompt_tokens", 0),
                                t.get("generated_tokens", 0),
                                _fmt_flops(t.get("flops", 0) or 0),
                                t.get("page_seconds", 0) or 0,
                                t.get("prefix_hit_tokens", 0),
                                t.get("replay_tokens", 0),
                                " — " + ocs if ocs else ""))
            train = u.get("training")
            if train:
                goodput = train.get("goodput")
                lines.append("  training   : %d step(s), %.3f "
                             "device*s%s%s"
                             % (train.get("steps", 0),
                                train.get("device_seconds", 0.0),
                                ", %s total"
                                % _fmt_flops(train["total_flops"])
                                if train.get("total_flops") else "",
                                ", goodput %.1f%% (%d wasted -> "
                                "effective %.3f device*s)"
                                % (100.0 * goodput,
                                   train.get("wasted_steps", 0),
                                   train.get(
                                       "effective_device_seconds",
                                       0.0))
                                if goodput is not None else ""))
            ledger = u.get("ledger")
            if isinstance(ledger, dict) and ledger.get("path"):
                lines.append("  ledger     : %d record(s) -> %s "
                             "(%d write error(s))"
                             % (ledger.get("written", 0),
                                ledger.get("path"),
                                ledger.get("errors", 0)))
            checks = _usage_checks(u, router_rec)
            if checks:
                ok = all(c[3] for c in checks)
                bad = ["%s (%s != %s)" % (c[0], c[1], c[2])
                       for c in checks if not c[3]]
                lines.append("  reconcile  : %d/%d conservation "
                             "check(s) hold (dual-entry books + "
                             "router counters)%s  [%s]"
                             % (sum(1 for c in checks if c[3]),
                                len(checks),
                                " — " + ", ".join(bad) if bad else "",
                                "OK" if ok else "MISMATCH"))

    # -- SLO watchdog alerts (mxnet_tpu.livemetrics) --------------------
    alerts = tel.get("alerts") or []
    if not alerts and summary.get("alerts"):
        alerts = summary["alerts"]
    if alerts:
        lines.append("----------Alerts----------")
        lines.append("%6s %-20s %s" % ("step", "kind", "detail"))
        for a in alerts:
            lines.append("%6s %-20s %s"
                         % (a.get("seq", "-"),
                            (a.get("kind") or "?")[:20],
                            a.get("message", "")))
        lines.append("%d alert(s) fired by the SLO watchdog "
                     "(MXNET_WATCHDOG=1; thresholds via "
                     "MXNET_WATCHDOG_* envs)" % len(alerts))

    # -- shape bucketing (mxnet_tpu.bucketing) --------------------------
    buck_recs = tel.get("bucketing") or []
    # records are cumulative per producer name: keep each name's last
    buck = {}
    for rec in buck_recs:
        buck[rec.get("name") or "default"] = rec
    if not buck:
        buck = dict(summary.get("bucketing") or {})
    if buck:
        lines.append("----------Bucketing----------")
        for name in sorted(buck):
            b = buck[name]
            from ..bucketing.ladder import bucket_sort_key
            per_bucket = " ".join(
                "b%s:%s" % kv
                for kv in sorted((b.get("buckets") or {}).items(),
                                 key=lambda kv: bucket_sort_key(kv[0])))
            lines.append("%-12s : %d batch(es) over %d bucket(s) (%s)"
                         % (name[:12], b.get("batches", 0),
                            len(b.get("buckets") or {}),
                            per_bucket or "-"))
            share = b.get("padding_share")
            lines.append("  padding    : %s of padded-batch elements "
                         "were padding (pad rows %d)"
                         % ("%.1f%%" % (100.0 * share)
                            if share is not None else "n/a",
                            b.get("pad_rows", 0)))
            rtf = b.get("real_token_fraction")
            if rtf is not None:
                lines.append("  real tokens: %.1f%% of emitted "
                             "elements were real work (the packing-"
                             "efficiency figure)" % (100.0 * rtf))
            lines.append("  samples    : %d bucketed, %d discarded "
                         "(longer than the ladder top)"
                         % (b.get("samples", 0), b.get("discarded", 0)))

    lines.append("----------Goodput----------")
    skipped = sum(s.get("skipped", 0) for s in steps)
    retried = sum(s.get("retries", 0) for s in steps)
    samples = sum(s.get("samples", 0) for s in steps)
    n = len(steps)
    productive = n - skipped
    lines.append("steps        : %d (productive %d, skipped %d, "
                 "retried ops %d)" % (n, productive, skipped, retried))
    if n:
        lines.append("goodput      : %.1f%%" % (100.0 * productive / n))
    events = summary.get("events") or {}
    gen = events.get("supervisor_restart_generation")
    if gen:
        # reconcile the supervisor's restart-the-world count with the
        # resume accounting fault.stats() carries: a supervised
        # restart that found a clean manifest resumes cleanly; one
        # that rolled past torn epochs shows up in the rollback
        # counters below
        fstats = summary.get("fault") or {}
        lines.append("restarts     : supervisor restart generation %d "
                     "(resumes this run: %d clean, %d rollback)"
                     % (gen, fstats.get("clean_resumes", 0),
                        fstats.get("rollback_resumes", 0)))
    rollback = events.get("resume_rollback_epochs")
    if rollback:
        # reconcile lost work with the rollback the resume scan took:
        # steps/epoch comes from the run itself. The meta begin_epoch
        # predates the resume bump, so prefer the resume_next_epoch
        # event (the epoch training actually restarted from)
        meta = run.get("meta") or {}
        begin = events.get("resume_next_epoch",
                           meta.get("begin_epoch"))
        lost = ""
        if n and meta.get("num_epoch") is not None \
                and begin is not None:
            epochs_run = max(int(meta["num_epoch"]) - int(begin), 1)
            lost = " (~%d steps of lost work re-trained)" \
                % (rollback * (n // epochs_run))
        lines.append("rollback     : resume skipped %d corrupt newer "
                     "epoch(s)%s" % (rollback, lost))
    if samples and durs:
        lines.append("samples/sec  : %.2f"
                     % (samples / (sum(durs) / 1e3)))
    if summary.get("fault"):
        lines.append("fault.stats  : %s" % json.dumps(summary["fault"]))
    if summary.get("events"):
        # free-form telemetry.note() events — e.g.
        # fused_step_eager_monitor explains "why was this run eager"
        lines.append("events       : %s" % json.dumps(summary["events"]))

    lines.append("----------Memory----------")
    watermarks = {}
    for m in tel.get("memory") or []:
        dev = m.get("device", "?")
        peak = max(int(m.get("peak_bytes_in_use", 0) or 0),
                   int(m.get("bytes_in_use", 0) or 0))
        watermarks[dev] = max(watermarks.get(dev, 0), peak)
    if not watermarks and summary.get("memory"):
        watermarks = {d: w.get("peak_bytes_in_use", 0)
                      for d, w in summary["memory"].items()}
    if watermarks:
        for dev in sorted(watermarks):
            lines.append("%-24s peak %s"
                         % (dev, _fmt_bytes(watermarks[dev])))
    else:
        lines.append("no memory samples (backend without memory_stats)")
    breakdown = summary.get("memory_breakdown") or tel.get("breakdown")
    if breakdown:
        # the FSDP/ZeRO split: how much of each device's residency is
        # a 1/N shard vs a full replica — the observable form of the
        # "params drop to 1/N" claim, per run
        total = sum(int(breakdown.get(k, 0) or 0)
                    for k in ("params_sharded", "params_replicated",
                              "opt_state"))
        for key, label in (("params_sharded", "params sharded (1/N)"),
                           ("params_replicated", "params replicated"),
                           ("opt_state", "optimizer state")):
            b = int(breakdown.get(key, 0) or 0)
            share = (100.0 * b / total) if total else 0.0
            lines.append("%-24s %12s  (%5.1f%%) per device"
                         % (label, _fmt_bytes(b), share))

    all_comms = summary.get("comms") or {}
    h2d = {k: v for k, v in all_comms.items() if k.startswith("h2d:")}
    sync = {k: v for k, v in all_comms.items()
            if k.startswith("grad_sync:")}
    links = {k: v for k, v in all_comms.items()
             if k.startswith(("ici:", "dcn:"))}
    comms = {k: v for k, v in all_comms.items()
             if not k.startswith(("h2d:", "grad_sync:", "ici:",
                                  "dcn:"))}

    if sync:
        # the bucketed gradient exchange (parallel.grad_sync): one row
        # per bucket. In-program buckets (reduce-scatter scheduled by
        # XLA inside the step) carry bytes but no host-observable
        # latency; eager kvstore buckets carry both.
        lines.append("----------Gradient sync----------")
        lines.append("%-24s %8s %12s %12s" % ("bucket", "steps",
                                              "bytes", "time(ms)"))
        tot_b = tot_ms = 0.0
        for key in sorted(sync):
            c = sync[key]
            tot_b += c.get("bytes", 0)
            tot_ms += c.get("time_ms", 0.0)
            lines.append("%-24s %8d %12d %12.3f"
                         % (key[len("grad_sync:"):], c.get("calls", 0),
                            c.get("bytes", 0), c.get("time_ms", 0.0)))
        lines.append("%-24s %8s %12d %12.3f" % ("TOTAL", "", tot_b,
                                                tot_ms))
        whole = sum(totals.values()) or 1.0
        share = 100.0 * totals.get("sync", 0.0) / whole
        steps_synced = (summary.get("events") or {}).get(
            "grad_sync_steps")
        if steps_synced:
            lines.append("in-program   : %d step(s) synced inside the "
                         "compiled step (overlapped with backward — "
                         "no host sync phase)" % steps_synced)
        lines.append("sync share   : %.1f%% of accounted phase time "
                     "(%d bucket(s)/step)" % (share, len(sync)))

    if links:
        # the mesh-layout audit: how much of each collective kind's
        # combine traffic rides the intra-host fast link (ici) vs the
        # cross-host link (dcn) under mesh.link_split's hop model — a
        # data axis split on host boundaries shows dcn ONLY here
        lines.append("----------Per-link comms (ici vs dcn)----------")
        lines.append("%-24s %8s %14s %14s %7s"
                     % ("collective", "calls", "ici bytes",
                        "dcn bytes", "dcn%"))
        kinds = sorted({k.split(":", 1)[1] for k in links})
        tot_i = tot_d = 0
        for kind in kinds:
            ici = links.get("ici:%s" % kind) or {}
            dcn = links.get("dcn:%s" % kind) or {}
            bi, bd = ici.get("bytes", 0), dcn.get("bytes", 0)
            tot_i += bi
            tot_d += bd
            calls = max(ici.get("calls", 0), dcn.get("calls", 0))
            share = 100.0 * bd / (bi + bd) if (bi + bd) else 0.0
            lines.append("%-24s %8d %14d %14d %6.1f%%"
                         % (kind[:24], calls, bi, bd, share))
        tot_share = 100.0 * tot_d / (tot_i + tot_d) \
            if (tot_i + tot_d) else 0.0
        lines.append("%-24s %8s %14d %14d %6.1f%%"
                     % ("TOTAL", "", tot_i, tot_d, tot_share))

    lines.append("----------Comms----------")
    if comms:
        lines.append("%-24s %8s %12s %12s" % ("kind:key", "calls",
                                              "bytes", "time(ms)"))
        for key in sorted(comms):
            c = comms[key]
            lines.append("%-24s %8d %12d %12.3f"
                         % (key, c.get("calls", 0), c.get("bytes", 0),
                            c.get("time_ms", 0.0)))
    else:
        lines.append("no comms records (run had no kvstore/collectives "
                     "or no summary record)")

    if h2d:
        # the input pipeline's device-prefetch transfers run on the
        # placer thread: comparing their total time with the data_wait
        # phase shows how much H2D was hidden behind compute
        lines.append("----------H2D transfer (input pipeline)----------")
        lines.append("%-24s %8s %12s %12s" % ("key", "copies", "bytes",
                                              "time(ms)"))
        tot_ms = tot_b = 0.0
        for key in sorted(h2d):
            c = h2d[key]
            tot_ms += c.get("time_ms", 0.0)
            tot_b += c.get("bytes", 0)
            lines.append("%-24s %8d %12d %12.3f"
                         % (key[len("h2d:"):], c.get("calls", 0),
                            c.get("bytes", 0), c.get("time_ms", 0.0)))
        lines.append("%-24s %8s %12d %12.3f" % ("TOTAL", "", tot_b,
                                                tot_ms))
        wait_ms = totals.get("data_wait", 0.0)
        lines.append("h2d placement ran on the prefetch thread, off "
                     "the step critical path (%.3f ms); consumer "
                     "data_wait (queue-dry stalls only) was %.3f ms"
                     % (tot_ms, wait_ms))
    return "\n".join(lines)


def _last_by_name(recs, fallback):
    """Cumulative-snapshot record streams (serving/decode/router/
    bucketing): the last record per name is the truth."""
    by = {}
    for rec in recs or []:
        by[rec.get("name") or "default"] = rec
    if not by and fallback:
        by = dict(fallback)
    return by or None


_USAGE_SUM_FIELDS = ("prompt_tokens", "generated_tokens",
                     "replay_tokens", "replay_cached_tokens", "flops",
                     "page_seconds", "prefix_hit_tokens",
                     "prefix_bytes_saved", "queue_ms", "failovers")


def _usage_view(tel, summary):
    """Latest ``usage`` meter snapshot per name (falling back to the
    summary block) — or, when diagnose is pointed straight at a
    ``MXNET_METER_FILE`` ledger, one snapshot synthesized from its
    raw per-request ``usage_record`` lines."""
    us = _last_by_name(tel.get("usage"), (summary or {}).get("usage"))
    if us:
        return us
    recs = tel.get("usage_records") or []
    if not recs:
        return None
    tenants = {}
    outcomes = {}
    totals = {k: 0 for k in _USAGE_SUM_FIELDS}
    for r in recs:
        t = tenants.get(r.get("tenant") or "?")
        if t is None:
            t = tenants[r.get("tenant") or "?"] = dict(
                {k: 0 for k in _USAGE_SUM_FIELDS},
                outcomes={}, closed=0, open=0)
        for k in _USAGE_SUM_FIELDS:
            t[k] += r.get(k, 0) or 0
            totals[k] += r.get(k, 0) or 0
        oc = r.get("outcome") or "?"
        t["outcomes"][oc] = t["outcomes"].get(oc, 0) + 1
        outcomes[oc] = outcomes.get(oc, 0) + 1
        t["closed"] += 1
    return {"ledger": {
        "name": "ledger", "admitted": len(recs),
        "closed": len(recs), "open": 0, "dispatched": None,
        "tenants": tenants, "outcomes": outcomes, "totals": totals,
        "synthesized": True}}


def _usage_checks(u, router):
    """The conservation cross-checks for one meter snapshot:
    ``(name, lhs, rhs, ok)`` tuples — the meter's own dual-entry
    verdict plus its totals against the Router's independently
    incremented counters (when a router record is in the same
    sink)."""
    checks = []
    rc = u.get("reconcile") or {}
    if rc:
        checks.append(("books", "sum-over-tenants", "totals",
                       bool(rc.get("ok"))))
    if router and u.get("dispatched") is not None:
        tot = u.get("totals") or {}
        oc = u.get("outcomes") or {}
        failed_group = oc.get("timeout", 0) + oc.get("preempted", 0) \
            + oc.get("failed", 0)
        for name, lhs, rhs in (
                ("admitted", u.get("admitted"),
                 router.get("requests")),
                ("dispatched", u.get("dispatched"),
                 router.get("dispatched")),
                ("completed", oc.get("completed", 0),
                 router.get("completed")),
                ("cancelled", oc.get("cancelled", 0),
                 router.get("cancelled")),
                ("shed", oc.get("shed", 0), router.get("shed")),
                ("failed", failed_group, router.get("failed")),
                ("replay_tokens", tot.get("replay_tokens"),
                 router.get("replay_tokens")),
                ("replay_cached_tokens",
                 tot.get("replay_cached_tokens"),
                 router.get("replay_cached_tokens")),
                ("throttles", u.get("throttle_events"),
                 router.get("throttles"))):
            if rhs is None:
                continue
            checks.append((name, lhs, rhs, lhs == rhs))
    return checks


def telemetry_json(tel):
    """The ``--format json`` mirror of :func:`format_telemetry`: every
    table as one structured record — same aggregation, no layout."""
    from ..telemetry import percentile
    run = tel.get("run") or {}
    summary = tel.get("summary") or {}
    steps = tel.get("steps") or []
    durs = [s["dur_ms"] for s in steps if s.get("dur_ms") is not None]
    out = {"run_id": run.get("run_id") or summary.get("run_id"),
           "meta": run.get("meta") or None,
           "skipped_lines": tel.get("skipped_lines", 0),
           "unknown_kinds": tel.get("unknown_kinds") or {}}
    out["step_time"] = {
        "steps": len(durs),
        "mean_ms": sum(durs) / len(durs),
        "p50_ms": percentile(durs, 50),
        "p90_ms": percentile(durs, 90),
        "p99_ms": percentile(durs, 99),
        "max_ms": max(durs)} if durs else None
    totals = dict(summary.get("phases_ms") or {})
    if not totals:
        for s in steps:
            for phase, ms in (s.get("phases_ms") or {}).items():
                totals[phase] = totals.get(phase, 0.0) + ms
    out["phases_ms"] = totals or None
    # compilation: the same per-program fold format_telemetry renders
    compiles = tel.get("compiles") or []
    sum_compile = summary.get("compile") or {}
    progs = {}
    for c in compiles:
        p = progs.setdefault(c.get("program", "?"),
                             {"count": 0, "ms": 0.0, "causes": {},
                              "churn": {}})
        p["count"] += 1
        p["ms"] += c.get("dur_ms", 0.0)
        cause = (c.get("cause") or "?").split(" ", 1)[0]
        p["causes"][cause] = p["causes"].get(cause, 0) + 1
        for arg in c.get("changed", ()):
            p["churn"][arg] = p["churn"].get(arg, 0) + 1
    if not progs:
        for name, s in (sum_compile.get("programs") or {}).items():
            progs[name] = {"count": s.get("count", 0),
                           "ms": s.get("total_s", 0.0) * 1e3,
                           "causes": dict(s.get("causes") or {}),
                           "churn": dict(s.get("churn") or {})}
    out["compilation"] = {
        "programs": progs,
        "storms": sum_compile.get("storms") or [],
        "cache": sum_compile.get("cache") or None} \
        if (progs or sum_compile) else None
    utils = tel.get("utilization") or []
    sum_util = summary.get("utilization") or {}
    if utils or sum_util:
        mfus = [u["mfu"] for u in utils if u.get("mfu") is not None]
        bwus = [u["bw_util"] for u in utils
                if u.get("bw_util") is not None]
        out["utilization"] = {
            "device_kind": sum_util.get("device_kind"),
            "n_devices": sum_util.get("n_devices"),
            "mfu_p50": percentile(mfus, 50) if mfus
            else (sum_util.get("mfu") or {}).get("p50"),
            "mfu_p90": percentile(mfus, 90) if mfus
            else (sum_util.get("mfu") or {}).get("p90"),
            "bw_p50": percentile(bwus, 50) if bwus else None}
    else:
        out["utilization"] = None
    out["checkpoints"] = tel.get("checkpoints") or \
        (summary.get("checkpoint") or None)
    servings = tel.get("serving") or []
    out["serving"] = servings[-1] if servings \
        else (summary.get("serving") or None)
    out["decode"] = _last_by_name(tel.get("decode"),
                                  summary.get("decode"))
    out["router"] = _last_by_name(tel.get("router"),
                                  summary.get("router"))
    out["prefix_cache"] = _last_by_name(tel.get("prefix_cache"),
                                        summary.get("prefix_cache"))
    out["bucketing"] = _last_by_name(tel.get("bucketing"),
                                     summary.get("bucketing"))
    usage = _usage_view(tel, summary)
    if usage:
        rt = out["router"] or {}
        router_rec = next(iter(rt.values())) if len(rt) == 1 else None
        for u in usage.values():
            checks = _usage_checks(u, router_rec)
            u["reconcile_checks"] = [
                {"check": c[0], "meter": c[1], "counter": c[2],
                 "ok": c[3]} for c in checks]
            u["reconciled"] = all(c[3] for c in checks) \
                if checks else None
    out["usage"] = usage
    out["loss_scale"] = tel.get("loss_scale") or None
    out["alerts"] = tel.get("alerts") or summary.get("alerts") or []
    skipped = sum(s.get("skipped", 0) for s in steps)
    out["goodput"] = {
        "steps": len(steps),
        "productive": len(steps) - skipped,
        "skipped": skipped,
        "retried_ops": sum(s.get("retries", 0) for s in steps),
        "events": summary.get("events") or {},
        "fault": summary.get("fault") or {}}
    watermarks = {}
    for m in tel.get("memory") or []:
        dev = m.get("device", "?")
        peak = max(int(m.get("peak_bytes_in_use", 0) or 0),
                   int(m.get("bytes_in_use", 0) or 0))
        watermarks[dev] = max(watermarks.get(dev, 0), peak)
    if not watermarks and summary.get("memory"):
        watermarks = {d: w.get("peak_bytes_in_use", 0)
                      for d, w in summary["memory"].items()}
    out["memory"] = {
        "peak_bytes": watermarks or None,
        "breakdown": summary.get("memory_breakdown")
        or tel.get("breakdown")}
    out["comms"] = summary.get("comms") or None
    return out


# ---------------------------------------------------------------------------
# fleet mode: a directory or glob of per-rank / per-worker sinks
# ---------------------------------------------------------------------------

# the launcher's per-worker naming convention: rank 0 keeps the
# configured filename, rank N>0 gets base.workerN.ext (tools/launch.py,
# telemetry's per-worker sinks, MXNET_TRACE_FILE fan-out)
_WORKER_RE = re.compile(r"\.worker(\d+)\.[^.]+$")


def _sink_rank(name):
    m = _WORKER_RE.search(name)
    return int(m.group(1)) if m else 0


def read_fleet(paths):
    """Parse every input in ``paths``: telemetry JSONL sinks plus
    ``flightrec-*.json`` bundles. An unreadable or torn input becomes a
    counted entry in ``warnings`` and is skipped — the fleet report
    renders the survivors, it never aborts on one bad rank."""
    fleet = {"ranks": [], "bundles": [], "warnings": []}
    for path in paths:
        base = os.path.basename(path)
        if base.startswith("flightrec-") and base.endswith(".json"):
            try:
                with open(path) as f:
                    fleet["bundles"].append({"path": path,
                                             "bundle": json.load(f)})
            except (OSError, ValueError) as exc:
                fleet["warnings"].append(
                    "torn flight-recorder bundle %s skipped (%s)"
                    % (base, exc))
            continue
        try:
            tel = read_telemetry(path)
        except OSError as exc:
            fleet["warnings"].append(
                "unreadable sink %s skipped (%s)" % (base, exc))
            continue
        fleet["ranks"].append({"path": path, "rank": _sink_rank(base),
                               "tel": tel})
        if tel.get("skipped_lines"):
            fleet["warnings"].append(
                "%s: skipped %d unparseable line(s) — a killed rank "
                "strands at most one truncated trailing record"
                % (base, tel["skipped_lines"]))
    fleet["ranks"].sort(key=lambda r: (r["rank"], r["path"]))
    fleet["bundles"].sort(key=lambda b: b["path"])
    return fleet


def _rank_row(entry):
    """One cross-rank skew table row: the per-rank aggregates."""
    from ..telemetry import percentile
    tel = entry["tel"]
    steps = tel.get("steps") or []
    summary = tel.get("summary") or {}
    durs = [s["dur_ms"] for s in steps if s.get("dur_ms") is not None]
    totals = dict(summary.get("phases_ms") or {})
    if not totals:
        for s in steps:
            for phase, ms in (s.get("phases_ms") or {}).items():
                totals[phase] = totals.get(phase, 0.0) + ms
    n = len(durs)
    return {"rank": entry["rank"],
            "file": os.path.basename(entry["path"]),
            "run_id": (tel.get("run") or {}).get("run_id")
            or summary.get("run_id"),
            "gen": (summary.get("events") or {}).get(
                "supervisor_restart_generation", 0),
            "steps": n,
            "mean_ms": (sum(durs) / n) if n else None,
            "p50_ms": percentile(durs, 50) if n else None,
            "max_ms": max(durs) if n else None,
            "phase_mean_ms": {k: v / n for k, v in totals.items()}
            if n else {},
            "skipped_lines": tel.get("skipped_lines", 0)}


def _fleet_skew(rows):
    """Annotate each row with its delta vs the fastest rank and name
    the slowest rank, attributing its excess to the phase whose
    per-step mean exceeds the fleet mean the most."""
    timed = [r for r in rows if r["mean_ms"] is not None]
    if not timed:
        return None
    best = min(r["mean_ms"] for r in timed)
    for r in rows:
        r["delta_ms"] = (r["mean_ms"] - best) \
            if r["mean_ms"] is not None else None
    slow = max(timed, key=lambda r: r["mean_ms"])
    fleet_phase = {}
    for r in timed:
        for k, v in r["phase_mean_ms"].items():
            fleet_phase.setdefault(k, []).append(v)
    attribution = None
    if slow["phase_mean_ms"] and len(timed) > 1 and fleet_phase:
        deltas = {k: slow["phase_mean_ms"].get(k, 0.0)
                  - sum(vs) / len(vs)
                  for k, vs in fleet_phase.items()}
        phase = max(deltas, key=deltas.get)
        attribution = {"phase": phase, "delta_ms": deltas[phase]}
    return {"best_mean_ms": best, "slowest_rank": slow["rank"],
            "slowest_delta_ms": slow["mean_ms"] - best,
            "attribution": attribution}


def _fleet_serving(ranks):
    """Join router records against replica (decode) records across
    every sink: the conservation law is ``dispatched == admitted +
    replica-shed`` — every router dispatch lands in exactly one
    replica's submit accounting."""
    routers, servers = {}, {}
    alerts_lost = 0
    for e in ranks:
        tel = e["tel"]
        summary = tel.get("summary") or {}
        for name, rec in (_last_by_name(tel.get("router"),
                                        summary.get("router"))
                          or {}).items():
            routers[(e["rank"], name)] = rec
        for name, rec in (_last_by_name(tel.get("decode"),
                                        summary.get("decode"))
                          or {}).items():
            servers[(e["rank"], name)] = rec
        for a in tel.get("alerts") or (summary.get("alerts") or []):
            if a.get("kind") == "replica_lost":
                alerts_lost += 1
    if not routers and not servers:
        return None
    dispatched = sum(r.get("dispatched", 0) for r in routers.values())
    admitted = sum(s.get("requests", 0) - s.get("shed", 0)
                   for s in servers.values())
    replica_shed = sum(s.get("shed", 0) for s in servers.values())
    resume = [r.get("failover_resume_ms") for r in routers.values()
              if r.get("failover_resume_ms")]
    return {"routers": len(routers), "replicas": len(servers),
            "sessions": sum(r.get("requests", 0)
                            for r in routers.values()),
            "completed": sum(r.get("completed", 0)
                             for r in routers.values()),
            "dispatched": dispatched,
            "router_shed": sum(r.get("shed", 0)
                               for r in routers.values()),
            "admitted": admitted, "replica_shed": replica_shed,
            "reconciled": dispatched == admitted + replica_shed,
            "replicas_lost": sum(r.get("replicas_lost", 0)
                                 for r in routers.values()),
            "failovers": sum(r.get("failovers", 0)
                             for r in routers.values()),
            "replay_tokens": sum(r.get("replay_tokens", 0)
                                 for r in routers.values()),
            "resume_ms": resume,
            "replica_lost_alerts": alerts_lost}


def _bundle_summary(path, b):
    alert = b.get("alert") or {}
    ident = b.get("identity") or {}
    tr = b.get("trace") or {}
    return {"file": os.path.basename(path),
            "reason": b.get("reason"), "time": b.get("time"),
            "alert_kind": alert.get("kind"),
            "rank": ident.get("rank"), "gen": ident.get("gen"),
            "records": len(b.get("records") or ()),
            "trace_events": len(tr.get("traceEvents") or ()),
            "run_id": (b.get("run") or {}).get("run_id")}


def format_bundle_line(path, b):
    """The one-line flight-recorder bundle renderer."""
    s = _bundle_summary(path, b)
    return ("%-46s %-16s %-14s rank %s gen %s  %4d rec  %6d ev"
            % (s["file"][:46], (s["reason"] or "?")[:16],
               (s["alert_kind"] or "-")[:14], s["rank"], s["gen"],
               s["records"], s["trace_events"]))


def format_bundle(path, b):
    """The single-bundle detail view (diagnose on one
    ``flightrec-*.json``)."""
    lines = ["----------Flight-recorder bundle----------",
             format_bundle_line(path, b),
             "written      : %s" % (b.get("time") or "?")]
    alert = b.get("alert")
    if alert:
        lines.append("alert        : %s"
                     % json.dumps(alert, sort_keys=True))
    run = b.get("run")
    if run:
        lines.append("run          : %s"
                     % json.dumps(run, sort_keys=True))
    topo = b.get("topology")
    if topo:
        lines.append("topology     : %s"
                     % json.dumps(topo, sort_keys=True))
    ts = b.get("trace_stats")
    if ts:
        lines.append("trace        : %s"
                     % json.dumps(ts, sort_keys=True))
    return "\n".join(lines)


def _ms(v, sign=False):
    if v is None:
        return "-"
    return ("%+.3f" if sign else "%.3f") % v


def format_fleet(fleet):
    """Render the fleet report: cross-rank skew, restart-generation
    timeline, the router-vs-replica serving rollup, and one line per
    flight-recorder bundle."""
    rows = [_rank_row(e) for e in fleet["ranks"]]
    skew = _fleet_skew(rows)
    lines = ["----------Fleet telemetry----------",
             "sinks        : %d telemetry sink(s), %d flight-recorder "
             "bundle(s)" % (len(rows), len(fleet["bundles"]))]
    for w in fleet["warnings"]:
        lines.append("WARNING      : %s" % w)

    lines.append("----------Cross-rank skew----------")
    lines.append("%4s %4s %7s %10s %10s %10s %10s %10s  %s"
                 % ("rank", "gen", "steps", "mean(ms)", "p50(ms)",
                    "max(ms)", "wait(ms)", "vs best", "sink"))
    for r in rows:
        lines.append("%4s %4s %7d %10s %10s %10s %10s %10s  %s"
                     % (r["rank"], r["gen"], r["steps"],
                        _ms(r["mean_ms"]), _ms(r["p50_ms"]),
                        _ms(r["max_ms"]),
                        _ms(r["phase_mean_ms"].get("data_wait")),
                        _ms(r.get("delta_ms"), sign=True),
                        r["file"]))
    if skew:
        att = skew.get("attribution")
        lines.append("slowest      : rank %s (+%.3f ms/step vs best)%s"
                     % (skew["slowest_rank"],
                        skew["slowest_delta_ms"],
                        " — dominated by the '%s' phase (%+.3f ms "
                        "vs fleet mean)"
                        % (att["phase"], att["delta_ms"])
                        if att else ""))
    gens = sorted({r["gen"] for r in rows})
    if rows:
        if len(gens) == 1:
            lines.append("generations  : all ranks at restart "
                         "generation %s" % gens[0])
        else:
            lines.append("generations  : MIXED — ranks restarted "
                         "unevenly (a lagging rank resumed from an "
                         "older incarnation):")
            for r in rows:
                lines.append("  rank %-4s : generation %s (%s)"
                             % (r["rank"], r["gen"], r["file"]))

    sv = _fleet_serving(fleet["ranks"])
    bundles = [_bundle_summary(b["path"], b["bundle"])
               for b in fleet["bundles"]]
    if sv:
        lines.append("----------Fleet serving----------")
        lines.append("sessions     : %d submitted across %d router(s) "
                     "(completed %d, front-door shed %d)"
                     % (sv["sessions"], sv["routers"],
                        sv["completed"], sv["router_shed"]))
        lines.append("reconcile    : dispatched %d %s admitted %d + "
                     "replica-shed %d  [%s]"
                     % (sv["dispatched"],
                        "==" if sv["reconciled"] else "!=",
                        sv["admitted"], sv["replica_shed"],
                        "OK" if sv["reconciled"] else "MISMATCH"))
        lines.append("failover     : %d replica(s) lost, %d session(s) "
                     "re-homed, %d token(s) replayed by re-prefill"
                     % (sv["replicas_lost"], sv["failovers"],
                        sv["replay_tokens"]))
        for res in sv["resume_ms"]:
            lines.append("resume       : p50 %.3f ms  p99 %.3f ms  max "
                         "%.3f ms (loss detection -> first resumed "
                         "token)"
                         % (res.get("p50", 0.0), res.get("p99", 0.0),
                            res.get("max", 0.0)))
        n_alert_bundles = sum(1 for s in bundles
                              if s["alert_kind"] == "replica_lost")
        if sv["replica_lost_alerts"] or n_alert_bundles:
            ok = n_alert_bundles <= sv["replica_lost_alerts"]
            lines.append("flight rec   : %d replica_lost bundle(s) vs "
                         "%d replica_lost alert(s) across sinks  [%s]"
                         % (n_alert_bundles,
                            sv["replica_lost_alerts"],
                            "OK" if ok else "MISMATCH"))

    if fleet["bundles"]:
        lines.append("----------Flight recorder----------")
        for b in fleet["bundles"]:
            lines.append(format_bundle_line(b["path"], b["bundle"]))
    return "\n".join(lines)


def fleet_json(fleet):
    """The ``--format json`` mirror of :func:`format_fleet`."""
    rows = [_rank_row(e) for e in fleet["ranks"]]
    return {"sinks": len(rows),
            "warnings": list(fleet["warnings"]),
            "ranks": rows,
            "skew": _fleet_skew(rows),
            "serving": _fleet_serving(fleet["ranks"]),
            "bundles": [_bundle_summary(b["path"], b["bundle"])
                        for b in fleet["bundles"]]}


def _is_bundle_path(path):
    base = os.path.basename(path)
    return base.startswith("flightrec-") and base.endswith(".json")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Diagnose the current system, or render a "
                    "telemetry JSONL run.")
    p.add_argument("telemetry", nargs="?", default=None,
                   help="path to a mxnet_tpu.telemetry JSONL sink, a "
                        "flightrec-*.json bundle, or a directory/glob "
                        "of per-rank sinks (fleet mode); when given, "
                        "render the tables and exit")
    p.add_argument("--format", choices=("text", "json"),
                   default="text", dest="format_",
                   help="text tables (default) or the same tables "
                        "mirrored as structured JSON records")
    for choice in ("python", "os", "hardware", "mxnet", "backend"):
        p.add_argument("--" + choice, default=1, type=int)
    p.add_argument("--timeout", default=30, type=int)
    args = p.parse_args(argv)
    if args.telemetry:
        target = args.telemetry
        paths = None
        if os.path.isdir(target):
            paths = sorted(
                _glob.glob(os.path.join(target, "*.jsonl"))
                + _glob.glob(os.path.join(target, "flightrec-*.json"))
                + _glob.glob(os.path.join(target, "*",
                                          "flightrec-*.json")))
            if not paths:
                p.error("no telemetry sinks or flightrec bundles "
                        "under directory %r" % target)
        elif not os.path.isfile(target) and \
                any(ch in target for ch in "*?["):
            paths = sorted(_glob.glob(target))
            if not paths:
                p.error("glob %r matched nothing" % target)
        elif not os.path.isfile(target):
            p.error("telemetry sink %r not found (expected a "
                    "mxnet_tpu.telemetry JSONL file)" % target)
        if paths is not None:
            fleet = read_fleet(paths)
            if args.format_ == "json":
                print(json.dumps(fleet_json(fleet), indent=2,
                                 sort_keys=True))
            else:
                print(format_fleet(fleet))
            return
        if _is_bundle_path(target):
            with open(target) as f:
                bundle = json.load(f)
            if args.format_ == "json":
                print(json.dumps(_bundle_summary(target, bundle),
                                 indent=2, sort_keys=True))
            else:
                print(format_bundle(target, bundle))
            return
        if args.format_ == "json":
            print(json.dumps(telemetry_json(read_telemetry(target)),
                             indent=2, sort_keys=True))
        else:
            print(format_telemetry(read_telemetry(target)))
        return
    if args.python:
        diagnose_python()
    if args.os:
        diagnose_os()
    if args.hardware:
        diagnose_hardware()
    if args.mxnet:
        diagnose_mxnet()
    if args.backend:
        diagnose_backend(args.timeout)


if __name__ == "__main__":
    main()
