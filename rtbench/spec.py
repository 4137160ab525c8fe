"""Finding a cell's files by the names `BENCHMARK.json` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each lives in a file of its own, found by name, and a missing file
raises at once:

- ``rtbench/configs/<config>.json``: the deployment (image, caps, camera,
  mesh, map) with its source, ``assumed`` and ``reduced``. The scene is
  either ``mesh``, one generated mesh (`rtbench.inputs.make_mesh`:
  ``{"kind": "icosphere", ...}`` or ``{"kind": "nested_shell", ...}``),
  or ``scene``, placed instances of named meshes in the port's
  ``--instances`` format (`rtbench.inputs.make_instances`):
  ``{"kind": "instances", "meshes": {name: mesh spec}, "instances":
  [{"mesh": name, "translate": [x, y, z], "scale": s, "rotate_y_deg": d,
  "mask": m} or {"mesh": name, "transform": 3x4, "mask": m}, ...]}``,
  which the program builds with `scene.build_instanced_scene` and the
  reference bakes itself; so a deployment of placed instances is a new
  configuration file, and its cell new entries;
- ``rtbench/traffic/<traffic>.json``: the mix's parameters, read by the
  one general loop (`rtbench.harness`);
- ``rtbench/limits/<config>.<check>.json``: the limit of each number
  that decides ``correct`` (``limits``), for the kind of check the mix
  asks for, with the readings it was set from (``readings``);
- ``rtbench/metrics/<metric>.py``: the reader of a per-layer metric;
  where there is none, that of the name's first part
  (``rt_frame_ms.orbit`` and ``rt_frame_ms.accumulate`` read with
  ``rt_frame_ms.py``): a quantity split by the end-to-end metric it moves
  is read one way.

A later cell adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
BENCHMARK_JSON = os.path.join(REPO, "BENCHMARK.json")


def _load_json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


def config_path(name: str) -> str:
    return os.path.join(ROOT, "configs", f"{name}.json")


def traffic_path(name: str) -> str:
    return os.path.join(ROOT, "traffic", f"{name}.json")


def limits_path(config: str, check: str) -> str:
    return os.path.join(ROOT, "limits", f"{config}.{check}.json")


def metric_path(name: str) -> str:
    """The reader of per-layer metric ``name``: ``<name>.py``, else that of
    the name's first part."""
    own = os.path.join(ROOT, "metrics", f"{name}.py")
    if os.path.isfile(own):
        return own
    return os.path.join(ROOT, "metrics", f"{name.split('.')[0]}.py")


def load_reader(name: str):
    """The ``read(ctx)`` function of per-layer metric ``name``."""
    path = metric_path(name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"per-layer metric {name}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict | None
    end_to_end: list[dict]
    per_layer: list[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_bench(path: str = BENCHMARK_JSON) -> dict:
    return _load_json(path, "BENCHMARK.json")


def load_cell(name: str, bench: dict | None = None,
              with_limits: bool = True) -> Cell:
    """The cell ``name`` of ``bench`` (default: `BENCHMARK.json`), its
    configuration, traffic mix and limits, and the metrics it reports."""
    bench = load_bench() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    config = _load_json(config_path(w["config"]), f"config {w['config']}")
    traffic = _load_json(traffic_path(w["traffic"]),
                         f"traffic {w['traffic']}")
    limits = None
    if with_limits:
        limits = _load_json(limits_path(w["config"], traffic["check"]),
                            f"limits of {w['config']} ({traffic['check']})"
                            )["limits"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    for m in layer:
        if not os.path.isfile(metric_path(m["name"])):
            raise FileNotFoundError(f"per-layer metric {m['name']}: no "
                                    f"reader {metric_path(m['name'])}")
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, layer)
