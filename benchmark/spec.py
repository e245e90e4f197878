"""Find a cell's parts by name: the manifest (``BENCHMARK.json``), its
configuration file, its traffic mix, its limits, the per-layer metrics
it reports and its model's module.  Nothing is listed in code: a later
cell adds files and manifest entries, and edits none of these."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json, with its "name"
    traffic: dict         # workloads/<traffic>.json, with its "name"
    limits: dict          # limits/<cell>.json: number -> limit
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``,
    or, without that key, every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    """The cell ``name`` of the manifest with its files read."""
    m = manifest if manifest is not None else load_json(MANIFEST)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = {"name": conf["name"], **load_json(ROOT / conf["file"])}
    traffic = {"name": w["traffic"],
               **load_json(HERE / "workloads" / f"{w['traffic']}.json")}
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [e for e in m["end_to_end"]
           if "workloads" not in e or name in e["workloads"]]
    names = {e["name"] for e in e2e}
    per_layer = [p for p in m["per_layer"] if _reports(p, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read(ctx)`` (a ``.`` or ``-`` in the name
    is ``_`` in the file's): the metric's value from
    the traced run's context, or None where it finds nothing to read."""
    module = name.replace(".", "_").replace("-", "_")
    mod = importlib.import_module(f"benchmark.metrics.{module}")
    return mod.read


def model_module(cell: Cell):
    """``models/<model>.py`` of the cell's configuration's ``model``."""
    return importlib.import_module(
        f"benchmark.models.{cell.config['model']}")


def peaks() -> Dict[str, float]:
    return load_json(HERE / "peaks.json")
