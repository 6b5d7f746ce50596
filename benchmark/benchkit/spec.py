"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell lives in files of its own under the benchmark's directory:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives as ``file``)
- ``traffic/<traffic>.json``: the mix's parameters and its ``driver``
- ``drivers/<driver>.py``: the code that runs a kind of traffic
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``
- ``limits/<workload>.json``: the limits of the cell's correctness numbers
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_spec(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, bench_dir: Path) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return json.loads((Path(bench_dir) / kind / f"{name}.json").read_text())


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json("traffic", name, bench_dir)


def limits(workload_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``{number: limit}`` of the cell's correctness numbers."""
    return {k: float(v["limit"]) for k, v in _json("limits", workload_name, bench_dir).items()}


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<kind>/<name>.py`` of the benchmark (a driver or a
    metric's reader), imported from its file."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = Path(bench_dir) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end_for(spec: dict, workload_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports: those that list it, and
    those that list no cells."""
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or workload_name in m["workloads"]]


def per_layer_for(spec: dict, workload_name: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    that list no cells and move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(spec, workload_name)}
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if workload_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out
