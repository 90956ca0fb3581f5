"""`BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, traffic mix, driver,
per-layer metric, work model, reference or kernel family is a file of its
own under `portbench/`, found by the name the manifest (or a configuration
or traffic file) gives it:

    configs/<config>.json        the entry's "file" in BENCHMARK.json
    traffic/<mix>.json           a cell's "traffic"
    drivers/<driver>.py          a traffic file's "driver"
    metrics/<metric>.py          a per-layer metric's "name"
    work/<work>.py               a configuration's "work"
    reference/<reference>.py     a configuration's "reference"
    kernels/<family>.txt         kernel-name patterns, one a line

Adding a configuration, a mix, a metric or a kernel family is therefore a
new file and a new manifest entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in man['workloads']]}")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(man: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file, as it is run."""
    return json.loads((root / config_entry(man, name)["file"]).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """`portbench/<kind>/<name>.py` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    modname = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def kernel_families() -> dict[str, list[str]]:
    """{family: [name patterns]} from `kernels/*.txt`; a device kernel is
    of a family when one of its patterns is a substring of its name.
    Blank lines and lines starting with '#' are skipped."""
    out = {}
    for f in sorted((BENCH_DIR / "kernels").glob("*.txt")):
        pats = [ln.strip() for ln in f.read_text().splitlines()]
        out[f.stem] = [p for p in pats if p and not p.startswith("#")]
    return out


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(man: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) that `cell` reports.  A
    per-layer metric without a "workloads" key is reported wherever its
    `moves` metric is."""
    e2e = [m for m in man["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if m["moves"] in names and _applies(m, cell)]
    return e2e, per
