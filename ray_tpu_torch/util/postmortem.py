"""Postmortem bundles: one archive that explains an episode.

Port of `ray_tpu/util/postmortem.py` for one process. The process holds
every observability plane — the flight-recorder event tail
(util/events), the span buffer (util/tracing; engine.request spans carry
each request's id), the /metrics/cluster exposition, this process's
stats snapshot, and profile capture metas. ``build_bundle`` snapshots them
all into one ``.tgz`` whose ``timeline.json`` is the EPISODE
RECONSTRUCTION: runtime spans and typed events stitched into a single
wall-clock-aligned Perfetto timeline (slices + instant events +
cross-lane flow arrows) via the trace_dump merge path. The spans of other
nodes join the bundle with ROADMAP A6b (federation).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tarfile
import time
from typing import Any, Dict, List, Optional

__all__ = ["build_bundle", "collect_planes", "load_bundle", "reconstruct_timeline"]


def _all_spans() -> List[Dict[str, Any]]:
    """Every completed span of this process's ring."""
    from .tracing import tracer

    return sorted(tracer().spans(), key=lambda s: s["start_ts"])


def collect_planes(note: str = "") -> Dict[str, Any]:
    """Gather the bundle pieces from the live runtime. Every plane is
    best-effort — a postmortem of a half-dead process must still build
    from whatever still answers."""
    from . import state

    pieces: Dict[str, Any] = {"note": note, "created_at": time.time()}

    def grab(key, fn, fallback):
        try:
            pieces[key] = fn()
        except Exception as exc:  # noqa: BLE001 - partial bundles beat none
            pieces[key] = fallback
            pieces.setdefault("errors", {})[key] = repr(exc)

    grab("events", lambda: state.events(limit=0), [])
    grab("spans", _all_spans, [])
    grab("metrics", lambda: state.cluster_metrics(raw=False), "")
    grab("node_stats", state.node_stats, {})
    grab("nodes", state.list_nodes, [])
    grab("profiles", state.list_profiles, [])
    grab("summary", state.summary, {})
    return pieces


def reconstruct_timeline(events: List[Dict[str, Any]],
                         spans: List[Dict[str, Any]]) -> str:
    """Stitch typed events and runtime spans into one Perfetto JSON
    string. Spans render as nested slices with cross-lane flow arrows
    (export_chrome_trace); events become global instant events on a
    per-node ``events:<node>`` track, tid'd by emitting subsystem, so
    the announcement/checkpoint/restart breadcrumbs line up against the
    span slices on the shared wall clock."""
    from .tracing import export_chrome_trace

    instants: List[Dict[str, Any]] = []
    for e in events:
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        node = str(e.get("node") or "local")
        extra = e.get("extra") or {}
        instants.append({
            "name": e.get("kind") or f"{e.get('source', '?')}",
            "cat": "events",
            "ph": "i",
            "s": "g",  # global scope: draw the line across all tracks
            "ts": ts * 1e6,
            "pid": f"events:{node[:8]}",
            "tid": e.get("source", "events"),
            "args": {
                "severity": e.get("severity"),
                "kind": e.get("kind"),
                "message": e.get("message"),
                "node": e.get("node"),
                "seq": e.get("seq"),
                "mono": e.get("mono"),
                **{k: v for k, v in extra.items()
                   if isinstance(v, (str, int, float, bool, type(None)))},
            },
        })
    return export_chrome_trace(spans, extra_events=instants)


def build_bundle(output: str, note: str = "",
                 pieces: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write the postmortem archive to `output` (a .tgz path; parent
    dirs are created). Members:

    - ``manifest.json``       creation time, note, per-file size+sha256
    - ``events.jsonl``        the typed event tail
    - ``spans.jsonl``         every reachable completed span
    - ``timeline.json``       the reconstructed Perfetto episode timeline
    - ``metrics_cluster.prom``  the node_id-labelled Prometheus exposition
    - ``node_stats.json`` / ``nodes.json`` / ``profiles.json`` /
      ``summary.json``        runtime state at snapshot time

    The archive lands via tmp + os.replace (atomic-write discipline: a
    crash mid-build never leaves a torn bundle at the final path).
    Returns the manifest."""
    pieces = collect_planes(note) if pieces is None else pieces
    timeline = reconstruct_timeline(pieces.get("events", []),
                                    pieces.get("spans", []))
    members: Dict[str, bytes] = {
        "events.jsonl": "\n".join(
            json.dumps(e, default=str) for e in pieces.get("events", [])
        ).encode(),
        "spans.jsonl": "\n".join(
            json.dumps(s, default=str) for s in pieces.get("spans", [])
        ).encode(),
        "timeline.json": timeline.encode(),
        "metrics_cluster.prom": str(pieces.get("metrics", "")).encode(),
        "node_stats.json": json.dumps(
            pieces.get("node_stats", {}), default=str).encode(),
        "nodes.json": json.dumps(pieces.get("nodes", []), default=str).encode(),
        "profiles.json": json.dumps(
            pieces.get("profiles", []), default=str).encode(),
        "summary.json": json.dumps(
            pieces.get("summary", {}), default=str).encode(),
    }
    manifest = {
        "created_at": pieces.get("created_at", time.time()),
        "note": note,
        "errors": pieces.get("errors", {}),
        "counts": {
            "events": len(pieces.get("events", [])),
            "spans": len(pieces.get("spans", [])),
            "nodes": len(pieces.get("nodes", [])),
            "profiles": len(pieces.get("profiles", [])),
        },
        "files": {
            name: {
                "bytes": len(data),
                "sha256": hashlib.sha256(data).hexdigest(),
            }
            for name, data in members.items()
        },
    }
    members["manifest.json"] = json.dumps(
        manifest, indent=2, default=str).encode()

    output = os.path.abspath(output)
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    tmp = output + ".tmp"
    with tarfile.open(tmp, "w:gz") as tar:
        for name, data in sorted(members.items()):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = int(manifest["created_at"])
            tar.addfile(info, io.BytesIO(data))
    os.replace(tmp, output)
    return manifest


def load_bundle(path: str) -> Dict[str, Any]:
    """Read a bundle back: JSON members parsed, JSONL members as lists,
    the exposition as text — what tests and the CLI inspect."""
    out: Dict[str, Any] = {}
    with tarfile.open(path, "r:gz") as tar:
        for member in tar.getmembers():
            data = tar.extractfile(member).read()
            if member.name.endswith(".jsonl"):
                out[member.name] = [
                    json.loads(line) for line in data.decode().splitlines()
                    if line.strip()
                ]
            elif member.name.endswith(".json"):
                out[member.name] = json.loads(data.decode())
            else:
                out[member.name] = data.decode()
    return out
