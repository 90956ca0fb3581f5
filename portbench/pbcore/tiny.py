"""A cell cut to a size that a CPU test run holds: the same configuration
file and traffic file with the widths, depth and lengths cut, for the
tests that drive the rest of a run without a card."""

from __future__ import annotations

import copy

from pbcore import manifest

TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
            d_ff=256, vocab_size=512)
# the limit of the CPU tests' comparison: bf16 on the CPU reads 0.008 at
# most on phi4's tiny cut, its fp8 control 0.039 at least (four seeds)
TINY_WIDEST_GAP = 0.02


def tiny_cell(cell: str, man: dict | None = None):
    """(manifest, cell entry, configuration, traffic) of `cell` at the
    CPU size."""
    man = copy.deepcopy(man or manifest.load_manifest())
    w = manifest.workload(man, cell)
    cfg = manifest.load_config(man, w["config"])
    cut = dict(TINY, moe_d_ff=128) if cfg.get("n_experts") else dict(TINY)
    cfg["reduced"] = sorted(k for k, v in cut.items() if cfg.get(k) != v)
    cfg.update(cut)
    cfg["correct"] = {"widest_gap": TINY_WIDEST_GAP}
    traffic = manifest.load_traffic(w["traffic"])
    traffic.update(clients=4, max_batch=4, pool=64, block=16, ramp_ticks=8,
                   prompt_tokens={"dist": "loguniform", "lo": 8, "hi": 64},
                   output_tokens={"dist": "uniform", "lo": 4, "hi": 16},
                   sample={"min_served_tokens": 40, "max_requests": 4})
    return man, w, cfg, traffic
