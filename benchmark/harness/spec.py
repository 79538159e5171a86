"""Load and check `BENCHMARK.json` and the files it names.

The harness is driven by data. Every part that belongs to one
configuration, one traffic mix or one metric sits in a file of its own,
found by the name that `BENCHMARK.json` gives it:

- a configuration: the file its entry names (`benchmark/configs/<config>.json`);
- a traffic mix: `benchmark/traffic/<traffic>.json`, whose `kind` picks the
  generator (`harness/traffic.py`: `open_loop`, `backlog`, `train_batches`);
- a metric: `benchmark/metrics/<metric>.py`, whose `read(run)` returns the
  metric's value from a finished run, or None where it finds nothing.

So a later change adds a configuration, a mix or a metric by adding files
and entries, and edits none. `load_cell` resolves one workload into
everything a run needs; `validate` checks the whole file against the
benchmark's contract (names, units, keys, bounds, files) and raises
`SpecError` naming every fault it finds.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}
TRAFFIC_KINDS = {"open_loop": "serve", "backlog": "serve", "train_batches": "train"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
# a width may never be cut: hidden, intermediate, latent, state or
# projection sizes, *_dim / *_rank, head sizes, expansion factors, experts
# per token
WIDTH = re.compile(r"((hidden|intermediate|latent|state|proj[a-z_]*|head|ffn)_size$|_dim$|_rank$|"
                   r"expansion|experts_per_tok|^d_model$|^d_ff$|^n_embd$|^n_inner$)", re.IGNORECASE)


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, breaks the contract."""


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    read: Callable[[Any], Optional[float]]
    bound: Optional[float] = None
    layer: Optional[str] = None
    moves: Optional[str] = None


@dataclasses.dataclass
class Cell:
    """One workload resolved: its entry, its configuration's file, its
    traffic's parameters and the metrics it reports."""

    name: str
    entry: Dict[str, Any]
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    kind: str  # "serve" | "train"
    end_to_end: List[Metric]
    per_layer: List[Metric]
    run_seconds: int


def repo_root() -> Path:
    """The checkout's root: the directory that holds `benchmark/`."""
    return Path(__file__).resolve().parent.parent.parent


def bench_dir(root: Path) -> Path:
    return root / "benchmark"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Optional[Path] = None) -> Dict[str, Any]:
    root = root or repo_root()
    return load_json(root / "BENCHMARK.json")


def metric_reader(root: Path, name: str) -> Callable[[Any], Optional[float]]:
    """`benchmark/metrics/<name>.py`'s `read`, loaded by path (a metric's
    name may hold dots)."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    read = getattr(module, "read", None)
    if not callable(read):
        raise SpecError(f"{path} defines no read(run)")
    return read


def traffic_params(root: Path, name: str) -> Dict[str, Any]:
    path = bench_dir(root) / "traffic" / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"traffic {name!r} has no file {path}")
    params = load_json(path)
    if params.get("kind") not in TRAFFIC_KINDS:
        raise SpecError(f"{path}: kind {params.get('kind')!r} is not one of {sorted(TRAFFIC_KINDS)}")
    return params


def _applies(entry: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Optional[Path] = None,
              bench: Optional[Dict[str, Any]] = None) -> Cell:
    """Resolve workload `name` (raises SpecError for an unknown one)."""
    root = root or repo_root()
    bench = bench or load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"unknown workload {name!r}; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[entry["config"]]
    config = load_json(root / config_entry["file"])
    traffic = traffic_params(root, entry["traffic"])
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"], True,
                  metric_reader(root, m["name"]), bound=m["bound"])
           for m in bench["end_to_end"] if _applies(m, name)]
    layer = [Metric(m["name"], m["unit"], m["better"], m["source"], False,
                    metric_reader(root, m["name"]), layer=m["layer"], moves=m["moves"])
             for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name=name, entry=entry, config_name=entry["config"], config=config,
                traffic_name=entry["traffic"], traffic=traffic,
                kind=TRAFFIC_KINDS[traffic["kind"]], end_to_end=e2e, per_layer=layer,
                run_seconds=int(bench["run_seconds"]))


def _line(text: Any, limit: int = 200) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text
            and "\t" not in text)


def validate(root: Optional[Path] = None) -> Dict[str, Any]:
    """Check BENCHMARK.json and every file it names; return it. Raises
    SpecError listing every fault."""
    root = root or repo_root()
    raw = (root / "BENCHMARK.json").read_bytes()
    errors: List[str] = []
    if len(raw) > 64 * 1024:
        errors.append("BENCHMARK.json is over 64 KiB")
    bench = json.loads(raw)
    if set(bench) != TOP_KEYS:
        errors.append(f"top-level keys {sorted(bench)} != {sorted(TOP_KEYS)}")
    cmd = bench.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        errors.append("command must be 1-32 one-line words of 1-200 characters")
    paths = bench.get("paths", [])
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        errors.append("paths must list 1-16 directories")
    for p in paths:
        if not (isinstance(p, str) and PATH.match(p) and not p.startswith("/")
                and ".." not in p.split("/")):
            errors.append(f"bad path {p!r}")
    for word in cmd:
        if word.startswith("/") or ".." in word.split("/"):
            errors.append(f"command word {word!r} leaves the checkout")
        if "/" in word and not any(word == p or word.startswith(p.rstrip("/") + "/")
                                   for p in paths):
            errors.append(f"command word {word!r} names a file outside paths")
    rs = bench.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errors.append("run_seconds must be a whole number from 1 to 51")

    def check_names(kind: str, entries: List[Dict[str, Any]]) -> None:
        seen = set()
        for e in entries:
            n = e.get("name")
            if not (isinstance(n, str) and NAME.match(n)):
                errors.append(f"{kind} name {n!r} is not a name")
            if n in seen:
                errors.append(f"{kind} name {n!r} appears twice")
            seen.add(n)

    configs = bench.get("configs", [])
    workloads = bench.get("workloads", [])
    e2e = bench.get("end_to_end", [])
    layer = bench.get("per_layer", [])
    check_names("config", configs)
    check_names("workload", workloads)
    check_names("metric", e2e + layer)
    if not 1 <= len(configs) <= 24:
        errors.append("configs must have 1-24 entries")
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            errors.append(f"config {c.get('name')}: keys {sorted(c)} != {sorted(CONFIG_KEYS)}")
            continue
        if not (_line(c["source"]) and _line(c["why"])):
            errors.append(f"config {c['name']}: source and why are one line of 1-200 characters")
        f = c["file"]
        if f in files:
            errors.append(f"config file {f} used twice")
        files.add(f)
        if not any(f.startswith(p.rstrip("/") + "/") for p in paths):
            errors.append(f"config file {f} is not under paths")
        if not (root / f).is_file():
            errors.append(f"config file {f} does not exist")
        red = c["reduced"]
        if not (isinstance(red, list) and len(red) <= 16):
            errors.append(f"config {c['name']}: reduced must list at most 16 keys")
        else:
            for key in red:
                if not (isinstance(key, str) and NAME.match(key)):
                    errors.append(f"config {c['name']}: reduced key {key!r} is not a name")
                elif WIDTH.search(key):
                    errors.append(f"config {c['name']}: reduced names a width {key!r}")
        if not any(w.get("config") == c["name"] for w in workloads):
            errors.append(f"config {c['name']} is used by no workload")
    if not 1 <= len(workloads) <= 24:
        errors.append("workloads must have 1-24 entries")
    names_c = {c.get("name") for c in configs}
    pairs = set()
    for w in workloads:
        if set(w) != WORKLOAD_KEYS:
            errors.append(f"workload {w.get('name')}: keys {sorted(w)} != {sorted(WORKLOAD_KEYS)}")
            continue
        if w["config"] not in names_c:
            errors.append(f"workload {w['name']}: unknown config {w['config']!r}")
        if not NAME.match(str(w["traffic"])):
            errors.append(f"workload {w['name']}: traffic {w['traffic']!r} is not a name")
        if (w["config"], w["traffic"]) in pairs:
            errors.append(f"workload {w['name']}: config and traffic pair appears twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            errors.append(f"workload {w['name']}: chips must be 1 or 4")
        if not _line(w["why"]):
            errors.append(f"workload {w['name']}: why must be one line of 1-200 characters")
        try:
            traffic_params(root, w["traffic"])
        except SpecError as exc:
            errors.append(str(exc))
    if sum(w.get("chips") == 4 for w in workloads) > max(1, len(workloads) // 4):
        errors.append("too many four-chip cells")
    if not 1 <= len(e2e) <= 16:
        errors.append("end_to_end must have 1-16 metrics")
    if "setup_s" not in {m.get("name") for m in e2e}:
        errors.append("end_to_end must include setup_s")
    if not 1 <= len(layer) <= 128:
        errors.append("per_layer must have 1-128 metrics")
    wl_names = {w.get("name") for w in workloads}
    e2e_names = {m.get("name") for m in e2e}
    for m in e2e:
        if set(m) - {"workloads"} != E2E_KEYS:
            errors.append(f"metric {m.get('name')}: keys {sorted(m)}")
            continue
        b = m["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            errors.append(f"metric {m['name']}: bound {b} outside [0.01, 0.25]")
        if m["source"] not in E2E_SOURCES:
            errors.append(f"metric {m['name']}: an end-to-end source is host_clock or device_trace")
    layers_seen: Dict[str, str] = {}
    for m in layer:
        if set(m) - {"workloads"} != LAYER_KEYS:
            errors.append(f"metric {m.get('name')}: keys {sorted(m)}")
            continue
        if not _line(m["layer"]):
            errors.append(f"metric {m['name']}: layer must be one line of 1-200 characters")
        if m["moves"] not in e2e_names:
            errors.append(f"metric {m['name']}: moves unknown metric {m['moves']!r}")
        if m["source"] not in SOURCES:
            errors.append(f"metric {m['name']}: unknown source {m['source']!r}")
        layers_seen.setdefault(m["layer"].lower(), m["layer"])
        if layers_seen[m["layer"].lower()] != m["layer"]:
            errors.append(f"metric {m['name']}: layer {m['layer']!r} spelled unlike "
                          f"{layers_seen[m['layer'].lower()]!r}")
    for m in e2e + layer:
        if not (isinstance(m.get("unit"), str) and UNIT.match(m["unit"])):
            errors.append(f"metric {m.get('name')}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            errors.append(f"metric {m.get('name')}: better must be lower or higher")
        for wl in m.get("workloads", []):
            if wl not in wl_names:
                errors.append(f"metric {m.get('name')}: unknown workload {wl!r}")
        if NAME.match(str(m.get("name"))):
            try:
                metric_reader(root, m["name"])
            except SpecError as exc:
                errors.append(str(exc))
    for m in layer:
        moves = next((e for e in e2e if e.get("name") == m.get("moves")), None)
        if moves is None:
            continue
        for wl in m.get("workloads", sorted(wl_names)):
            if not _applies(moves, wl):
                errors.append(f"metric {m['name']}: cell {wl} does not report {m['moves']}")
    for w in workloads:
        n = w.get("name")
        reported = [m for m in e2e if _applies(m, n)]
        if not any(m.get("name") != "setup_s" for m in reported):
            errors.append(f"workload {n} reports no end-to-end metric besides setup_s")
        if not any(_applies(m, n) for m in layer):
            errors.append(f"workload {n} reports no per-layer metric")
    if errors:
        raise SpecError("BENCHMARK.json breaks the contract:\n  " + "\n  ".join(errors))
    return bench
