"""What the benchmark loads holds neither JAX nor the JAX package, and the
plain reference nothing of the program.  Top-level module names are
compared whole: the port, `repro_torch`, begins with the JAX package's
name, `repro`."""

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
SRC = BENCH.parent / "src"

_HARNESS = """
import json, sys, time, glob, os
from pathlib import Path
from types import SimpleNamespace
sys.path[:0] = [{bench!r}, {src!r}]
import torch
from pbcore import manifest, devtrace, judge, stats
from pbcore.tiny import tiny_cell
import importlib.util
spec = importlib.util.spec_from_file_location("portbench_run",
                                              {bench!r} + "/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
for kind in ("drivers", "metrics", "work", "reference"):
    for f in sorted(Path({bench!r}, kind).glob("*.py")):
        manifest.load_module(kind, f.stem)
man, w, cfg, traffic = tiny_cell("dbrx-chat")
line = run.execute(man, w, cfg, traffic,
                   SimpleNamespace(seed=3, seconds=0.5, trace=0),
                   torch.device("cpu"), time.perf_counter(), {{}})
print(json.dumps({{"line": line is not None,
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

_REFERENCE = """
import json, sys
sys.path[:0] = [{bench!r}]
from pbcore import manifest, judge
from pathlib import Path
for f in sorted(Path({bench!r}, "reference").glob("*.py")):
    manifest.load_module("reference", f.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_modules(code: str, home):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH.parent,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(home),
                              "TMPDIR": str(home), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_run_loads_no_jax(tmp_path):
    """The harness, every driver, reader, work model and reference, and a
    whole run at the CPU cut (the MoE cell: the most the port loads)."""
    got = _top_modules(_HARNESS.format(bench=str(BENCH), src=str(SRC)),
                       tmp_path)
    assert got["line"] is True
    assert "repro_torch" in got["top"]          # the program did run
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["top"])


def test_reference_loads_nothing_of_the_program(tmp_path):
    got = _top_modules(_REFERENCE.format(bench=str(BENCH)), tmp_path)
    assert "torch" in got
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & set(got)
