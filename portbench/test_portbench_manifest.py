"""BENCHMARK.json loads, its entries keep the benchmark's naming rules, and
every file a cell needs is found by name."""

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from pbcore import manifest  # noqa: E402

MAN = manifest.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = {"d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "moe_d_ff",
          "n_experts_per_tok", "lru_width", "ssm_state", "ssm_head_dim",
          "ssm_expand", "kv_lora_rank", "q_lora_rank"}


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert MAN["command"][1] == "portbench/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    for m in MAN["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["layer"] and "\n" not in m["layer"]
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = manifest.workload(MAN, cell)
    cfg = manifest.load_config(MAN, w["config"])
    traffic = manifest.load_traffic(w["traffic"])
    for kind, name in (("drivers", traffic["driver"]),
                       ("reference", cfg["reference"]),
                       ("work", cfg["work"])):
        assert hasattr(manifest.load_module(kind, name), "__file__")
    e2e, per_layer = manifest.cell_metrics(MAN, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    for m in per_layer:
        assert callable(manifest.load_module("metrics", m["name"]).read)
    assert any(f.startswith("gemm") for f in manifest.kernel_families())


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_file_is_the_run_configuration(entry):
    """The file's keys differ from the port's registry entry in exactly
    `reduced`, which names no width."""
    sys.path.insert(0, str(BENCH.parent / "src"))
    cfg = json.loads((BENCH.parent / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"]
    assert not WIDTHS & set(entry["reduced"])
    assert entry["source"] == cfg["source"]
    drv = manifest.load_module("drivers", "serve_stream")
    pcfg = drv.port_config(cfg)
    assert pcfg.n_layers == cfg["n_layers"]
    assert cfg["correct"] and all(v > 0 for v in cfg["correct"].values())
