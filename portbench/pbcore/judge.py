"""The comparison that decides `correct` for a served LM.

Teacher-forced: the reference runs once over each sampled request's
prompt and served tokens, and at every position that produced a served
token reads by how much that token's reference logit lies below the
reference's best ("the gap").  Greedy serving gives gap 0 wherever the
program and the reference agree on the argmax and a small gap where
rounding flips a near tie; a wrong token reads the logit spread.

`control_gaps` reads, at the same positions, the tokens that the
reference itself computed at a lower precision puts first: the control.
`checks` holds a reading against the configuration's limits, for a run
and for the control alike.
"""

from __future__ import annotations

import torch


def _rows(ref, c, w, prompts, served, precision):
    """Final hidden rows (n_tokens, d) at the positions that produced the
    served tokens (each request's prompt, then its tokens fed back)."""
    seqs = [list(p) + list(t[:-1]) for p, t in zip(prompts, served)]
    hs = ref.final_hidden(c, w, seqs, precision)
    return torch.cat([h[len(p) - 1:len(p) - 1 + len(t)]
                      for h, p, t in zip(hs, prompts, served)])


def gaps_of(ref, c: dict, w: dict, prompts, served, picks=None):
    """Gap, in the float32 reference, of `picks` (a token a position;
    default: the served tokens) at the positions of the served tokens."""
    ref.tf32_off()
    h = _rows(ref, c, w, prompts, served, "fp32")
    if picks is None:
        picks = torch.tensor([t for s in served for t in s],
                             device=h.device)
    best, _, got = ref.best_and_picked(c, w, h, picks.to(h.device))
    return best - got


def control_gaps(ref, c: dict, w: dict, prompts, served,
                 precision: str = "fp8") -> torch.Tensor:
    """The control's reading: at each position of the same prompts and
    served tokens, the gap of the token that the reference computed at
    `precision` puts first."""
    ref.tf32_off()
    hq = _rows(ref, c, w, prompts, served, precision)
    _, picks, _ = ref.best_and_picked(c, w, hq, torch.zeros(
        hq.shape[0], dtype=torch.long, device=hq.device), precision)
    del hq
    return gaps_of(ref, c, w, prompts, served, picks)


def summary(gaps: torch.Tensor) -> dict:
    """The widest gap, the mean gap, and the share of positions whose
    token is not the reference's argmax."""
    g = gaps.double()
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "off_argmax": float((g > 0).double().mean())}


def checks(limits: dict, got: dict, short: int, failed: int) -> list:
    """[(name, value, limit)] of one reading: the gaps of `got` (a
    `summary`) that the configuration gives a limit, the requests that
    returned fewer or more tokens than asked (`short`) and the requests
    that never finished (`failed`), both limit 0."""
    out = [(f"{k}_gap", got[k], limits[f"{k}_gap"])
           for k in ("widest", "mean") if f"{k}_gap" in limits]
    return out + [("short_requests", short, 0), ("failed", failed, 0)]


def passes(rows: list) -> bool:
    """`correct`: every number within its limit."""
    return all(v <= lim for _, v, lim in rows)
