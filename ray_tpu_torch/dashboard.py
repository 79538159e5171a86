"""Dashboard: a single-page cluster view over the state API + metrics.

Reference parity: Ray's aiohttp dashboard (python/ray/dashboard/head.py —
jobs/state/metrics modules). The dashboard is a thin
HTTP server over the EXISTING state API (util/state.py) and metrics
registry — JSON endpoints plus one self-refreshing HTML page and a trace
waterfall page; no build step.

Port of `ray_tpu/dashboard.py`: the same endpoints, the same REST job
submission over the port's `jobs.py` with its `Content-Type:
application/json` guard. The node-telemetry table reads each node's `cuda`
stats block (the caching allocator's allocated and reserved bytes, summed
over the node's CUDA devices) where JAX's counts the `tpu` block's devices.

    from ray_tpu_torch.dashboard import start_dashboard
    url = start_dashboard(port=8265)   # -> http://127.0.0.1:8265
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><style>
body{font-family:system-ui,sans-serif;margin:2em;background:#fafafa;color:#222}
h1{font-size:1.3em} h2{font-size:1.05em;margin-top:1.4em}
table{border-collapse:collapse;min-width:30em}
td,th{border:1px solid #ccc;padding:.25em .6em;font-size:.85em;text-align:left}
th{background:#eee} code{background:#eee;padding:0 .3em}
#err{color:#b00}
</style></head><body>
<h1>ray_tpu_torch dashboard</h1>
<div id="err"></div>
<h2>Cluster</h2><table id="summary"></table>
<h2>Autoscaler</h2><table id="autoscaler"></table>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Node telemetry</h2><table id="telemetry"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Recent tasks</h2><table id="tasks"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>Traces</h2><table id="traces"></table>
<h2>Profiles</h2><table id="profiles"></table>
<h2>Events</h2><table id="events"></table>
<h2>Logs (per node, last lines)</h2><pre id="logs" style="font-size:.75em;background:#eee;padding:.6em;max-height:22em;overflow:auto"></pre>
<script>
function fill(id, rows) {
  const t = document.getElementById(id);
  if (!rows.length) { t.innerHTML = "<tr><td>(none)</td></tr>"; return; }
  const cols = Object.keys(rows[0]);
  t.innerHTML = "<tr>" + cols.map(c => `<th>${c}</th>`).join("") + "</tr>" +
    rows.map(r => "<tr>" + cols.map(c =>
      `<td>${typeof r[c] === "object" ? JSON.stringify(r[c]) : r[c]}</td>`
    ).join("") + "</tr>").join("");
}
async function refresh() {
  try {
    const s = await (await fetch("/api/summary")).json();
    fill("summary", [s]);
    const sc = await (await fetch("/api/autoscaler")).json();
    fill("autoscaler", Object.keys(sc).length ? [sc] : []);
    fill("nodes", await (await fetch("/api/nodes")).json());
    const ns = await (await fetch("/api/node_stats")).json();
    fill("telemetry", Object.entries(ns).map(([node, t]) => ({
      node: node.slice(0, 12),
      cpu_pct: t.cpu_percent,
      rss_mb: (t.rss_bytes / 1048576).toFixed(1),
      store_bytes: (t.object_store || {}).host_bytes,
      objects: (t.object_store || {}).num_objects,
      pool: `${(t.worker_pool || {}).busy || 0} busy / ${(t.worker_pool || {}).idle || 0} idle`,
      queues: t.task_queues,
      cuda_allocated: (t.cuda || []).reduce((s, d) => s + (d.memory_allocated_bytes || 0), 0),
      cuda_reserved: (t.cuda || []).reduce((s, d) => s + (d.memory_reserved_bytes || 0), 0),
    })));
    fill("actors", await (await fetch("/api/actors")).json());
    const tasks = await (await fetch("/api/tasks")).json();
    fill("tasks", tasks.slice(-20).reverse());
    fill("jobs", await (await fetch("/api/jobs")).json());
    const tr = await (await fetch("/api/traces")).json();
    fill("traces", tr.slice(-15).reverse().map(t => ({
      trace: `<a href="/trace?id=${t.trace_id}">${t.trace_id.slice(0,12)}</a>`,
      root: t.root, spans: t.spans, errors: t.errors,
      duration_s: t.duration_s.toFixed(4),
    })));
    const pr = await (await fetch("/api/profiles")).json();
    fill("profiles", pr.slice(-10).reverse().map(p => ({
      profile: p.profile_id, nodes: Object.keys(p.nodes || {}).length,
      duration_s: p.duration_s, bytes: p.total_bytes,
    })));
    const ev = await (await fetch("/api/events")).json();
    fill("events", ev.slice(-15).reverse());
    const logs = await (await fetch("/api/logs")).json();
    document.getElementById("logs").textContent = Object.entries(logs)
      .map(([n, lines]) => `=== ${n} ===\n` + lines.slice(-12).join("\n"))
      .join("\n\n");
    document.getElementById("err").textContent = "";
  } catch (e) { document.getElementById("err").textContent = "refresh failed: " + e; }
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


_TRACE_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch trace</title><style>
body{font-family:system-ui,sans-serif;margin:2em;background:#fafafa;color:#222}
h1{font-size:1.2em} .row{position:relative;height:1.45em;margin:1px 0}
.bar{position:absolute;height:1.25em;background:#7aa7d6;border-radius:2px;
     font-size:.72em;padding:0 .3em;white-space:nowrap;overflow:visible;
     color:#102a43;line-height:1.7}
.bar.err{background:#d67a7a}
.lane{font-size:.72em;color:#666;position:absolute;left:0;width:11em;
      overflow:hidden;text-overflow:ellipsis}
#chart{position:relative;margin-left:11.5em}
#meta{font-size:.8em;color:#555;margin-bottom:1em}
</style></head><body>
<h1>trace waterfall</h1><div id="meta"></div>
<div style="position:relative"><div id="lanes"></div><div id="chart"></div></div>
<script>
const id = new URLSearchParams(location.search).get("id");
async function render() {
  const spans = await (await fetch("/api/trace?id=" + id)).json();
  if (!spans.length) { document.getElementById("meta").textContent =
      "no spans for trace " + id; return; }
  const t0 = Math.min(...spans.map(s => s.start_ts));
  const t1 = Math.max(...spans.map(s => s.end_ts || s.start_ts));
  const total = Math.max(t1 - t0, 1e-6);
  document.getElementById("meta").textContent =
    `trace ${id} — ${spans.length} spans, ${(total*1000).toFixed(2)} ms`;
  const chart = document.getElementById("chart");
  const lanes = document.getElementById("lanes");
  spans.sort((a, b) => a.start_ts - b.start_ts);
  spans.forEach((s, i) => {
    const left = 100 * (s.start_ts - t0) / total;
    const width = Math.max(100 * ((s.end_ts || s.start_ts) - s.start_ts) / total, 0.15);
    const row = document.createElement("div"); row.className = "row";
    const bar = document.createElement("div");
    bar.className = "bar" + (s.status !== "OK" ? " err" : "");
    bar.style.left = left + "%"; bar.style.width = width + "%";
    bar.textContent = `${s.name} (${((s.duration_s||0)*1000).toFixed(2)} ms)`;
    bar.title = JSON.stringify(s.attrs);
    row.appendChild(bar); chart.appendChild(row);
    const lane = document.createElement("div"); lane.className = "lane";
    lane.style.top = (i * 1.45 + 3.2) + "em"; lane.textContent = s.lane || "";
    lanes.appendChild(lane);
  });
}
render();
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def do_POST(self):  # noqa: N802 - http.server API
        """REST job submission (reference: dashboard job module behind
        `ray job submit`): POST /api/jobs {"entrypoint": "...", ...}."""
        try:
            if self.path != "/api/jobs":
                self._send(404, "not found", "text/plain")
                return
            # Require a JSON content type: cross-origin form POSTs (CSRF
            # "simple requests") cannot set it without a CORS preflight,
            # so a drive-by page cannot exec commands through this
            # endpoint (the real Ray dashboard's CVE-2023-48022 class).
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if ctype != "application/json":
                self._send(
                    415,
                    json.dumps({"error": "Content-Type must be application/json"}),
                    "application/json",
                )
                return
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            from .jobs import default_job_manager

            job_id = default_job_manager().submit(
                payload["entrypoint"],
                job_id=payload.get("job_id"),
                env_vars=payload.get("env_vars"),
                working_dir=payload.get("working_dir"),
                metadata=payload.get("metadata"),
            )
            self._send(200, json.dumps({"job_id": job_id}), "application/json")
        except Exception as e:  # noqa: BLE001 - handler must answer something
            self._send(400, json.dumps({"error": repr(e)}), "application/json")

    def do_GET(self):  # noqa: N802 - http.server API
        try:
            if self.path == "/" or self.path == "/index.html":
                self._send(200, _PAGE, "text/html")
                return
            if self.path.split("?", 1)[0] == "/trace":
                self._send(200, _TRACE_PAGE, "text/html")
                return
            if self.path.startswith("/api/"):
                from urllib.parse import parse_qs, urlparse

                parsed = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                if parsed.path == "/api/profile_artifact":
                    # binary download of one captured artifact
                    from .util import state

                    data = state.profile_artifact(
                        query["id"], query["node"], query["name"]
                    )
                    self._send_bytes(200, data, "application/octet-stream")
                    return
                self._send(200, json.dumps(self._api(parsed.path[5:], query)),
                           "application/json")
                return
            if self.path == "/metrics/cluster":
                from .util.metrics import cluster_prometheus_text

                self._send(200, cluster_prometheus_text(), "text/plain")
                return
            if self.path == "/metrics":
                from .util.metrics import registry

                self._send(200, registry().prometheus_text(), "text/plain")
                return
            self._send(404, "not found", "text/plain")
        except Exception as e:  # noqa: BLE001 - handler must answer something
            self._send(500, json.dumps({"error": repr(e)}), "application/json")

    def _api(self, name: str, query: Optional[dict] = None):
        from .util import state

        query = query or {}
        if name == "summary":
            return state.summary()
        if name == "nodes":
            return state.list_nodes()
        if name == "node_stats":
            return state.node_stats()
        if name == "cluster_metrics":
            return state.cluster_metrics(raw=True)
        if name == "autoscaler":
            # capacity-plane status: managed nodes by type/class, pending
            # demand by origin, scale/replace/blocked counters
            return state.autoscaler_summary() or {}
        if name == "head":
            # head fault-tolerance health: epoch, WAL lag/size, snapshot
            # age, restore/reconcile provenance, buffered federation
            return state.head_summary() or {}
        if name == "status":
            return {"report": state.status_report()}
        if name == "actors":
            return state.list_actors()
        if name == "tasks":
            return state.list_tasks()
        if name == "objects":
            return state.list_objects()
        if name == "timeline":
            # trace_dump directly: chrome_tracing_dump is a deprecated
            # alias of it now (same payload, minus the warning)
            return json.loads(state.trace_dump())
        if name == "traces":
            return state.list_traces()
        if name == "trace":
            # per-trace waterfall data: spans stitched cluster-wide
            if "id" not in query:
                raise ValueError("trace endpoint needs ?id=<trace_id>")
            return state.get_trace(query["id"])
        if name == "trace_export":
            return json.loads(state.trace_dump(
                trace_id=query.get("id"),
                profile_id=query.get("profile_id"),
            ))
        if name == "profiles":
            # artifact bytes stay behind /api/profile_artifact; the list
            # is meta only (per-node status + artifact names/sizes)
            return state.list_profiles()
        if name == "profile":
            if "id" not in query:
                raise ValueError("profile endpoint needs ?id=<profile_id>")
            return state.get_profile(query["id"])
        if name == "events":
            # the merged cluster-wide flight-recorder tail (filterable
            # like `ray_tpu_torch events`: ?kind=&node=&severity=&since=)
            return state.events(
                limit=int(query.get("limit", 200)),
                kind=query.get("kind"),
                node=query.get("node"),
                severity=query.get("severity"),
                since=float(query.get("since", 0.0)),
            )
        if name == "cluster_events":
            return state.cluster_events()
        if name == "requests":
            # request-forensics summaries (the on-call triage list:
            # ?tenant=&slow=1&limit=)
            return state.list_requests(
                tenant=query.get("tenant"),
                slow_only=query.get("slow", "0") in ("1", "true"),
                limit=int(query.get("limit", 200)),
            )
        if name == "request":
            # one request's cluster-wide phase timeline + the rendered
            # waterfall (the CLI's `request <id>` view)
            if "id" not in query:
                raise ValueError("request endpoint needs ?id=<request_id>")
            from .serve import reqlog

            marks = state.request_timeline(query["id"])
            return {
                "request_id": query["id"],
                "marks": marks,
                "decomposition": reqlog.decompose(marks),
                "waterfall": reqlog.render_waterfall(marks),
            }
        if name == "steps":
            # training-forensics sampled-step summaries (?run=&limit=),
            # or with ?run= plus ?waterfall=1 the run's rendered
            # per-rank waterfall + skew matrix (`steps <run>`)
            run = query.get("run")
            if run and query.get("waterfall", "0") in ("1", "true"):
                from .train import steplog

                summaries = state.step_timeline(run)
                return {
                    "run": run,
                    "steps": summaries,
                    "skew": steplog.skew_matrix(summaries),
                    "waterfall": steplog.render_waterfall(summaries),
                }
            return state.list_steps(
                run=run,
                limit=int(query.get("limit", 200)),
            )
        if name == "engines":
            # live engine introspection: lane table, page pool, prefix
            # cache chains, fair-queue depths (this process's engines)
            return state.engine_snapshot()
        if name == "goodput":
            # serve-side SLO attainment + any train goodput gauges land
            # in /metrics; this endpoint serves the serve ledger
            from .util.goodput import serve_slo_report

            return serve_slo_report()
        if name == "logs":
            # the UI shows ~12 lines/node; don't ship 200 per refresh
            return state.cluster_logs(tail=20)
        if name == "jobs":
            from .jobs import _default_manager

            if _default_manager is None:
                return []
            return [
                {
                    "job_id": j.job_id,
                    "status": j.status.value,
                    "entrypoint": j.entrypoint,
                    "submitted_at": j.submitted_at,
                    "returncode": j.returncode,
                }
                for j in _default_manager.list()
            ]
        raise ValueError(f"unknown endpoint {name!r}")

    def _send(self, code: int, body: str, ctype: str) -> None:
        self._send_bytes(code, body.encode(), ctype)

    def _send_bytes(self, code: int, data: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


_server: Optional[ThreadingHTTPServer] = None


def start_dashboard(port: int = 8265, host: str = "127.0.0.1") -> str:
    """Serve the dashboard for the current runtime; returns its URL.
    port=0 picks a free port."""
    global _server
    if _server is not None:
        return f"http://{_server.server_address[0]}:{_server.server_address[1]}"
    _server = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(
        target=_server.serve_forever, daemon=True, name="ray-tpu-torch-dashboard"
    ).start()
    return f"http://{host}:{_server.server_address[1]}"


def stop_dashboard() -> None:
    global _server
    if _server is not None:
        _server.shutdown()
        _server = None
