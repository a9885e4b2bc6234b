"""Live ops plane: per-process HTTP endpoints and the flight recorder.

The counterpart of ``thunder_tpu/observability/opsplane.py``: a process you
can SCRAPE (``/metrics``), ASK (``/healthz``, ``/debug/state``), and whose
faults carry their own preceding context (the flight recorder's dump).

Off by default; the plane arms via :func:`enable` (facade:
``thunder_tpu_torch.monitor.serve()``) or ``THUNDER_TPU_OPS_PORT`` at the
first ``jit``. With it off nothing is installed: the event emit paths pay
one module-global truth test and the dispatch fast path pays nothing.

**Flight recorder**: a bounded in-memory ring of the last N structured
events (everything the event pipeline emits, step timings included), kept
even when ``THUNDER_TPU_EVENTS`` is unset. On a fault that matters
(``CollectiveTimeoutError``, ``SDCDetectedError``, ``AutopilotHalt``, an
unhandled dispatch fault) the ring dumps a self-contained
``flightrec-<ts>-<reason>.jsonl`` (tmp-write, then rename; bounded
retention) whose records validate against the event schema and whose
trailing ``flightrec_dump`` marker tells the replay's correlation rules
"this log is a fault-in-progress capture". ``/debug/flightrec`` dumps on
demand.

**Ops server**: a stdlib ``ThreadingHTTPServer`` on a daemon thread:

==================  =========================================================
``/metrics``        ``monitor.prometheus_text(include_host=True)``
``/healthz``        the typed verdict (:func:`health_verdict`): watchdog
                    arm-state and abandoned workers, host-health spread,
                    federation, de-opt levels, event-log drops, in-flight
                    snapshot flushes, quarantines, profiles, the timeline,
                    recent anomalies
``/debug/state``    the live jitted functions' cache state, quarantines,
                    the autopilot's ladders and last decisions, detectors,
                    recorder, roofline, timeline, federation ledger
``/debug/flightrec``  dump the ring now; returns the path and record count
==================  =========================================================

``/debug/roofline`` and ``/debug/critpath`` serve the roofline ledger's and
the fleet timeline's ``debug_state``. The detector bank
(:class:`~thunder_tpu_torch.observability.detect.DetectorBank`) rides the
same event tap.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Optional

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm
from thunder_tpu_torch.observability.detect import DetectorBank, DetectorConfig

DUMP_PREFIX = "flightrec-"
_DUMP_REASONS = ("collective_timeout", "sdc", "autopilot_halt",
                 "dispatch_fault", "manual")


# =============================================================================
# Flight recorder
# =============================================================================


class FlightRecorder:
    """Bounded ring of fully-enveloped event records + atomic fault dumps.

    ``record`` is the ops-plane event tap: it builds the same envelope the
    JSONL log writes (``v``/``ts``/``seq``/``kind``/``pid``/``host`` — its
    own monotonic ``seq``) so a dumped file replays through
    ``analysis/events.replay_events`` unmodified. ``dump`` snapshots the
    ring, writes ``<dir>/flightrec-<ts>-<reason>.jsonl`` via tmp→rename
    (a crash mid-dump can never tear a dump), appends the
    ``flightrec_dump`` trailer marker, sweeps retention down to ``keep``
    files, and records the dump. Dumps with NO new records since the last
    one are skipped (``reason="manual"`` excepted): one fault unwinding
    through several except blocks must not spray identical dumps."""

    def __init__(self, capacity: int = 512, directory: Optional[str] = None,
                 keep: int = 16):
        self.capacity = int(capacity)
        self.keep = int(keep)
        self.directory = directory or os.environ.get(
            "THUNDER_TPU_FLIGHTREC_DIR", ""
        ) or os.path.join(os.getcwd(), "flightrec")
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._last_dump_seq = -1
        self._lock = threading.Lock()
        self.dumps: deque = deque(maxlen=32)  # (ts, reason, path, n_records)
        self._dead = False

    # -- the tap ---------------------------------------------------------------

    def record(self, kind: str, fields: dict) -> None:
        rec = {"v": obs_events.SCHEMA_VERSION, "ts": time.time(), "kind": kind}
        rec.update(obs_events.host_identity())
        rec.update(fields)
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._ring.append(rec)

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> list:
        with self._lock:
            return [dict(r) for r in self._ring]

    # -- dumping ---------------------------------------------------------------

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Atomically dump the ring; returns the path, or None when skipped
        (no new records since the last dump, a dead directory, or I/O
        failure — the black box must never take the workload down)."""
        if self._dead:
            return None
        with self._lock:
            if self._seq == self._last_dump_seq and reason != "manual":
                return None  # same fault unwinding through a second trigger
            records = [dict(r) for r in self._ring]
            self._last_dump_seq = self._seq
            trailer_seq = self._seq
        now = time.time()
        trailer = {
            "v": obs_events.SCHEMA_VERSION, "ts": now,
            "kind": "flightrec_dump", "reason": str(reason),
            "records": len(records), "seq": trailer_seq,
        }
        trailer.update(obs_events.host_identity())
        stamp = time.strftime("%Y%m%dT%H%M%S", time.localtime(now))
        name = f"{DUMP_PREFIX}{stamp}.{int(now * 1e3) % 1000:03d}-{reason}.jsonl"
        path = os.path.join(self.directory, name)
        n = 1
        while os.path.exists(path):
            path = os.path.join(self.directory, f"{name[:-6]}.{n}.jsonl")
            n += 1
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                for rec in records:
                    f.write(json.dumps(rec, default=str))
                    f.write("\n")
                f.write(json.dumps(trailer, default=str))
                f.write("\n")
            os.replace(tmp, path)
        except OSError as e:
            self._dead = True
            import warnings

            warnings.warn(
                f"thunder_tpu_torch flight recorder disabled after I/O failure "
                f"under {self.directory!r}: {e}", stacklevel=2,
            )
            return None
        obsm.FLIGHTREC_DUMPS.inc_always(reason=str(reason))
        self.dumps.append((now, str(reason), path, len(records)))
        self._sweep()
        return path

    def _sweep(self) -> None:
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith(DUMP_PREFIX) and n.endswith(".jsonl")
            )
        except OSError:
            return
        for name in names[:-self.keep] if self.keep > 0 else []:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass

    def debug_state(self) -> dict:
        return {
            "capacity": self.capacity,
            "records": len(self._ring),
            "directory": self.directory,
            "dumps": [
                {"ts": round(ts, 3), "reason": reason, "path": path,
                 "records": n}
                for ts, reason, path, n in list(self.dumps)
            ],
        }


# =============================================================================
# Health verdict
# =============================================================================

_STATUS_RANK = {"ok": 0, "degraded": 1, "critical": 2}


def _worst(a: str, b: str) -> str:
    return a if _STATUS_RANK[a] >= _STATUS_RANK[b] else b


def health_verdict(plane: Optional["OpsPlane"] = None, *,
                   spread_threshold: float = 1.5,
                   flush_stuck_s: float = 30.0,
                   anomaly_window_s: float = 300.0) -> dict:
    """The typed ``/healthz`` verdict: per-component status composed into
    the worst overall. Components:

    - ``event_log`` — the ``thunder_tpu_event_log_dropped_total`` counter
      (``inc_always``: visible with metrics off); any dropped sink means
      this host is flying blind → degraded;
    - ``watchdog`` — armed state + abandoned workers (degraded when any
      worker leaked, critical at the refuse-to-arm cap);
    - ``host_health`` — the detector bank's ONLINE spread when ≥2 hosts
      reported, else the last offline ``host_health`` summary; stragglers
      → degraded;
    - ``federation`` — per-slice fleet health when a membership ledger is
      installed: lost/cooldown slices or a DCN-tier slow slice
      → degraded, zero surviving width → critical; absent on unfederated
      runs;
    - ``deopt`` — the process-wide max de-opt ladder level (any de-opted
      function → degraded: the process is trading speed for survival);
    - ``checkpoint`` — in-flight background flushes; one stuck past
      ``flush_stuck_s`` → degraded (disk durability is stalling);
    - ``quarantine`` — live executor quarantines → degraded;
    - ``profile`` — profiler bracket captures: any that failed
      (``thunder_tpu_profile_captures_total{ok="false"}``) → degraded, since
      every roofline probe behind it measured nothing;
    - ``timeline`` — the fleet critical-path recorder when
      armed: fewer than two reporting hosts (nothing to cross-host join)
      or low clock-alignment confidence → degraded; absent when no
      recorder is installed;
    - ``anomalies`` — detector verdicts within ``anomaly_window_s``:
      any warn → degraded, any critical → critical."""
    plane = plane if plane is not None else current()
    status = "ok"
    reasons: list[str] = []
    components: dict[str, Any] = {}

    def comp(name: str, st: str, detail: dict, reason: Optional[str] = None):
        nonlocal status
        components[name] = dict(detail, status=st)
        if st != "ok" and reason:
            reasons.append(reason)
        status = _worst(status, st)

    dropped = obsm.EVENT_LOG_DROPPED.value()
    comp("event_log", "degraded" if dropped else "ok",
         {"dropped_sinks": dropped},
         f"{dropped} event-log sink(s) lost to I/O failure")

    from thunder_tpu_torch.resilience import watchdog as wd

    abandoned = wd.abandoned_worker_count()
    cap = wd.max_abandoned_workers()
    wd_status = "ok"
    if abandoned >= cap:
        wd_status = "critical"
    elif abandoned:
        wd_status = "degraded"
    comp("watchdog", wd_status,
         {"armed": wd.enabled(), "timeout_s": wd.active_timeout(),
          "abandoned_workers": abandoned, "cap": cap},
         f"{abandoned}/{cap} abandoned watchdog worker(s)")

    spread = None
    stragglers: list = []
    if plane is not None and plane.bank is not None:
        online = plane.bank.spread_state()
        if online is not None:
            spread = online["spread_ratio"]
            stragglers = online["stragglers"]
    if spread is None:
        summary = wd.last_host_health()
        if summary:
            spread = summary.get("spread_ratio")
            stragglers = list(summary.get("stragglers") or ())
    hh_status = "degraded" if stragglers else "ok"
    comp("host_health", hh_status,
         {"spread_ratio": spread, "stragglers": stragglers},
         f"straggler suspect(s): {stragglers}")

    from thunder_tpu_torch.resilience import federation as fed_mod

    ledger = fed_mod.current_ledger()
    if ledger is not None:
        fed = ledger.debug_state()
        lost = [r["slice"] for r in fed["slices"] if r["state"] == "lost"]
        cooldown = [r["slice"] for r in fed["slices"]
                    if r["state"] == "cooldown"]
        slow = None
        if plane is not None and plane.bank is not None:
            ss = plane.bank.slice_spread_state()
            if ss is not None:
                slow = ss["slow_slices"]
        fed_status = "ok"
        if cooldown or slow:
            fed_status = "degraded"
        if lost:
            fed_status = "degraded" if fed["width"] else "critical"
        comp("federation", fed_status,
             {"width": fed["width"], "n_slices": fed["n_slices"],
              "lost_slices": lost, "cooldown_slices": cooldown,
              "slow_slices": slow},
             f"fleet at width {fed['width']}/{fed['n_slices']} "
             f"(lost={lost}, cooldown={cooldown}, slow={slow})")

    from thunder_tpu_torch.resilience import deopt as deopt_mod

    level = deopt_mod.process_max_level()
    comp("deopt", "degraded" if level else "ok", {"max_level": level},
         f"de-opt ladder at L{level} (speed traded for survival)")

    from thunder_tpu_torch.resilience import preemption as preempt_mod

    flushes = preempt_mod.inflight_flushes()
    stuck = [f for f in flushes if f["for_s"] > flush_stuck_s]
    comp("checkpoint", "degraded" if stuck else "ok",
         {"inflight_flushes": flushes},
         f"background flush stuck > {flush_stuck_s:g}s: {stuck}")

    from thunder_tpu_torch.resilience import demotion

    quarantined = demotion.quarantine_snapshot()
    comp("quarantine", "degraded" if quarantined else "ok",
         {"entries": len(quarantined)},
         f"{len(quarantined)} quarantined (sym, executor) pair(s)")

    # Failed profiler captures: any ok="false" bump means a profile bracket
    # measured nothing, which would otherwise stay invisible until someone
    # read the roofline ledger and noticed it never grew.
    degraded_caps = obsm.PROFILE_CAPTURES.value(ok="false")
    comp("profile", "degraded" if degraded_caps else "ok",
         {"captures_ok": obsm.PROFILE_CAPTURES.value(ok="true"),
          "captures_degraded": degraded_caps},
         f"{degraded_caps} profiler capture(s) failed")

    # Fleet timeline: a silently dead critical-path recorder
    # must be as visible as a missing profiler — degraded when fewer than
    # two hosts ever reported (no cross-host path to decompose) or when the
    # weakest non-outlier clock alignment is low-confidence.
    from thunder_tpu_torch.observability import timeline as timeline_mod

    tl = timeline_mod.health_state()
    if tl is not None:
        conf = tl.get("min_confidence")
        tl_status = "ok"
        if tl["hosts"] < 2:
            tl_status = "degraded"
        elif conf is not None and conf < 0.5:
            tl_status = "degraded"
        comp("timeline", tl_status, tl,
             f"fleet timeline degraded: hosts={tl['hosts']}, "
             f"alignment confidence={conf}")

    recent: list = []
    if plane is not None and plane.bank is not None:
        recent = plane.bank.recent_anomalies(within_s=anomaly_window_s)
    an_status = "ok"
    for a in recent:
        an_status = _worst(an_status, "critical" if a.severity == "critical"
                           else "degraded")
    comp("anomalies", an_status,
         {"recent": [
             {"anomaly": a.kind, "severity": a.severity, "ts": round(a.ts, 3),
              "value": round(a.value, 6), "suspect_host": a.suspect_host}
             for a in recent[-8:]
         ]},
         f"{len(recent)} anomaly(ies) in the last {anomaly_window_s:g}s")

    if plane is not None and plane.recorder is not None:
        components["flight_recorder"] = {
            "status": "ok",
            "records": len(plane.recorder),
            "dumps": len(plane.recorder.dumps),
        }
    return {"status": status, "reasons": reasons, "components": components,
            "ts": round(time.time(), 3)}


def debug_state(plane: Optional["OpsPlane"] = None) -> dict:
    """The ``/debug/state`` payload: everything an operator attaches to a
    ticket — per-function cache/compile state, quarantines, the autopilot's
    hysteresis ladders and last decisions, detector + recorder state."""
    plane = plane if plane is not None else current()
    from thunder_tpu_torch import api
    from thunder_tpu_torch.resilience import autopilot as ap_mod
    from thunder_tpu_torch.resilience import demotion

    out: dict[str, Any] = {
        "cache": api.live_function_state(),
        "quarantine": {
            f"{sym}|{ex}": round(ttl, 1)
            for (sym, ex), ttl in demotion.quarantine_snapshot().items()
        },
    }
    # in_process, not current: the HTTP handlers run on threads of their
    # own, which do not see the context the training thread installed in.
    ap = ap_mod.in_process()
    out["autopilot"] = ap.debug_state() if ap is not None else None
    from thunder_tpu_torch.resilience import federation as fed_mod

    ledger = fed_mod.current_ledger()
    out["federation"] = ledger.debug_state() if ledger is not None else None
    # `is not None`, not truthiness: an EMPTY FlightRecorder is falsy
    # (it defines __len__) but very much installed.
    out["flight_recorder"] = (
        plane.recorder.debug_state()
        if plane is not None and plane.recorder is not None else None
    )
    out["detectors"] = (
        plane.bank.debug_state()
        if plane is not None and plane.bank is not None else None
    )
    from thunder_tpu_torch.observability import roofline as roofline_mod

    out["roofline"] = roofline_mod.debug_state()
    from thunder_tpu_torch.observability import timeline as timeline_mod

    out["timeline"] = timeline_mod.debug_state()
    return out


# =============================================================================
# The HTTP server
# =============================================================================


class OpsServer:
    """stdlib-threaded HTTP endpoint serving the ops routes. Binds
    ``127.0.0.1`` by default (``THUNDER_TPU_OPS_HOST`` widens it); port 0
    asks the OS for an ephemeral port — read it back from ``.port``."""

    def __init__(self, plane: "OpsPlane", port: int = 0,
                 host: Optional[str] = None):
        import http.server

        self.plane = plane
        host = host or os.environ.get("THUNDER_TPU_OPS_HOST", "127.0.0.1")
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # never spam the training job's stderr
                pass

            def _send(self, code: int, body: str, ctype: str):
                payload = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                route = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    obsm.OPS_REQUESTS.inc(route=route)
                    if route == "/metrics":
                        import thunder_tpu_torch.monitor as monitor

                        self._send(200, monitor.prometheus_text(include_host=True),
                                   "text/plain; version=0.0.4")
                    elif route == "/healthz":
                        verdict = health_verdict(outer.plane)
                        code = 503 if verdict["status"] == "critical" else 200
                        self._send(code, json.dumps(verdict, default=str),
                                   "application/json")
                    elif route == "/debug/state":
                        self._send(200, json.dumps(debug_state(outer.plane),
                                                   default=str),
                                   "application/json")
                    elif route == "/debug/roofline":
                        from thunder_tpu_torch.observability import (
                            roofline as roofline_mod)

                        self._send(200, json.dumps(
                            roofline_mod.debug_state(), default=str),
                            "application/json")
                    elif route == "/debug/critpath":
                        from thunder_tpu_torch.observability import (
                            timeline as timeline_mod)

                        self._send(200, json.dumps(
                            timeline_mod.debug_state(), default=str),
                            "application/json")
                    elif route == "/debug/flightrec":
                        rec = outer.plane.recorder
                        if rec is None:
                            self._send(404, '{"error": "no flight recorder"}',
                                       "application/json")
                            return
                        path = rec.dump("manual")
                        self._send(200, json.dumps(
                            {"path": path, "records": len(rec)}),
                            "application/json")
                    else:
                        self._send(404, '{"error": "unknown route"}',
                                   "application/json")
                except BrokenPipeError:
                    pass
                except Exception as e:  # the ops plane never kills the job
                    try:
                        self._send(500, json.dumps({"error": str(e)}),
                                   "application/json")
                    except Exception:
                        pass

        self._httpd = http.server.ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="thunder-tpu-torch-ops",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)


# =============================================================================
# Plane lifecycle
# =============================================================================


class OpsPlane:
    """One enabled ops plane: recorder + detector bank + (optional) server."""

    def __init__(self, recorder: Optional[FlightRecorder],
                 bank: Optional[DetectorBank],
                 server: Optional[OpsServer] = None):
        self.recorder = recorder
        self.bank = bank
        self.server = server

    @property
    def port(self) -> Optional[int]:
        return self.server.port if self.server is not None else None

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
            self.server = None


_state: dict = {"plane": None, "autostarted": False}


def current() -> Optional[OpsPlane]:
    return _state["plane"]


def enable(port: Optional[int] = None, *,
           serve: Optional[bool] = None,
           flightrec: bool = True,
           flightrec_capacity: int = 512,
           flightrec_dir: Optional[str] = None,
           flightrec_keep: int = 16,
           detectors: Any = True) -> OpsPlane:
    """Arm the ops plane (facade: ``thunder_tpu_torch.monitor.serve()``).

    ``port`` (or ``THUNDER_TPU_OPS_PORT``; 0 = ephemeral) starts the HTTP
    server; ``serve=False`` arms only the recorder + detectors. ``detectors``
    is True (defaults), a :class:`~thunder_tpu_torch.observability.detect.
    DetectorConfig`, or False. Re-enabling replaces the previous plane.
    Returns the :class:`OpsPlane`; ``plane.port`` holds the bound port."""
    disable()
    recorder = FlightRecorder(
        capacity=flightrec_capacity, directory=flightrec_dir,
        keep=flightrec_keep,
    ) if flightrec else None
    bank = None
    if detectors:
        cfg = detectors if isinstance(detectors, DetectorConfig) else None
        bank = DetectorBank(cfg)
    plane = OpsPlane(recorder, bank)
    if serve is None:
        serve = port is not None or bool(
            os.environ.get("THUNDER_TPU_OPS_PORT", "").strip())
    if serve:
        if port is None:
            try:
                port = int(os.environ.get("THUNDER_TPU_OPS_PORT", "0"))
            except ValueError:
                port = 0
        # Bind BEFORE installing the event taps: a failed bind must leave
        # nothing armed (taps with no registered plane would silently tax
        # every emit and write dumps nobody can find or shut down).
        plane.server = OpsServer(plane, port=port)
    taps = []
    if recorder is not None:
        taps.append(recorder.record)
    if bank is not None:
        taps.append(bank.consume)
    obs_events.set_ops_taps(tuple(taps), recorder=recorder)
    _state["plane"] = plane
    return plane


def disable() -> None:
    """Tear the plane down: stop the server, uninstall the event taps."""
    plane = _state["plane"]
    _state["plane"] = None
    obs_events.set_ops_taps((), recorder=None)
    if plane is not None:
        plane.close()


def maybe_autostart() -> Optional[OpsPlane]:
    """One-shot env autostart (``api._ensure_runtime`` calls this when
    ``THUNDER_TPU_OPS_PORT`` is set): the zero-config spelling for a fleet
    launched by a scheduler that exports one port per process."""
    if _state["autostarted"] or _state["plane"] is not None:
        return _state["plane"]
    _state["autostarted"] = True
    env = os.environ.get("THUNDER_TPU_OPS_PORT", "").strip()
    if not env:
        return None
    try:
        port = int(env)
    except ValueError:
        return None
    try:
        return enable(port=port)
    except OSError:
        import warnings

        warnings.warn(
            f"thunder_tpu_torch ops plane: cannot bind THUNDER_TPU_OPS_PORT={env}",
            stacklevel=2,
        )
        return None


def flight_dump(reason: str = "manual") -> Optional[str]:
    """Dump the flight recorder now (no-op None when the plane is off) —
    delegates to the one installed-recorder source of truth the fault
    sites use (``events.flight_dump``)."""
    return obs_events.flight_dump(reason)
