"""Find a cell's parts by the names in ``BENCHMARK.json`` and in its
files: its workload entry, its configuration file and its traffic file
(``portbench/workloads/<traffic>.json``); the modules those files name
(``module``); and the per-layer metrics that read it
(``portbench/metrics/<name>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name``: ``{"workload", "config", "traffic"}``, each the
    parsed entry or file."""
    bench = bench or benchmark()
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "workloads" / f"{work['traffic']}.json").read_text())
    return {"workload": work, "config": config, "traffic": traffic}


def module(folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py`` that a configuration or
    traffic file names: a program (``programs``), a model kind
    (``model_kinds``), a reference (``reference``) or a reference
    resampler (``reference.resamplers``)."""
    if not name.isidentifier():
        raise ValueError(f"{name!r} names no module of portbench/{folder}")
    path = HERE.joinpath(*folder.split("."), f"{name}.py")
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    return importlib.import_module(f"portbench.{folder}.{name}")


def metrics_of(name: str, trace: bool, bench: dict | None = None) -> list:
    """The metric entries a run of cell ``name`` reports: the end-to-end
    ones without a trace, the per-layer ones with it; an entry with a
    ``workloads`` key only where it lists the cell."""
    bench = bench or benchmark()
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
