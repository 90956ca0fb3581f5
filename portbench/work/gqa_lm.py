"""Operations and bytes of a GQA decoder LM (dense SwiGLU or routed
SwiGLU experts), from its sizes alone: a frozen copy of the arithmetic
the port's `models/model.model_flops` and `chip_smoke.py`'s serve bounds
use, kept here so that a later change to the port cannot move the
yardstick.

Peaks: one NVIDIA H100 SXM, dense bf16 989 TFLOP/s, HBM 3.35 TB/s (the
published data sheet figures at the 700 W limit).

A configuration is the dict of its file (`portbench/configs/*.json`):
d_model, n_layers, n_heads, n_kv_heads, head_dim, d_ff, vocab_size,
tie_embeddings, and for experts n_experts, n_experts_per_tok, moe_d_ff.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
HBM_BW = 3.35e12
BF16 = 2
FP32 = 4


def is_moe(c: dict) -> bool:
    return bool(c.get("n_experts"))


def attn_shapes(c: dict) -> list[tuple[int, int]]:
    """(k, n) of a layer's attention projections: wq, wk, wv, wo."""
    d, h, kv, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    return [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]


def layer_params(c: dict) -> tuple[int, int]:
    """(parameters, active parameters) of one layer: projections, two
    norms, and the dense MLP or the router and every expert (k of E
    active)."""
    d = c["d_model"]
    n = sum(k * m for k, m in attn_shapes(c)) + 2 * d
    if is_moe(c):
        e, k, f = c["n_experts"], c["n_experts_per_tok"], c["moe_d_ff"]
        experts = e * 3 * d * f
        return n + d * e + experts, n + d * e + int(experts * k / e)
    dense = 3 * d * c["d_ff"]
    return n + dense, n + dense


def model_flops(c: dict, tokens: int, mode: str = "forward") -> float:
    """MODEL_FLOPS: 2 N T for a forward pass, 6 N T for training, N the
    active parameters without the input embedding; a tied LM head is
    counted once (as the head).  The port's `model_flops`, frozen."""
    d, v = c["d_model"], c["vocab_size"]
    n = c["n_layers"] * layer_params(c)[1] + d        # + final norm
    if c.get("tie_embeddings"):
        n += v * d
    else:
        n += d * v                                    # the untied head
    mult = 6.0 if mode == "train" else 2.0
    return mult * n * tokens


def gemm_cost(m: int, k: int, n: int, w_bytes: int = BF16,
              out_bytes: int = BF16) -> tuple[float, float]:
    """(operations, bytes) of an m x k by k x n product: each input byte
    read once and each output byte written once."""
    return 2.0 * m * k * n, float(k * n * w_bytes + m * k * BF16
                                  + m * n * out_bytes)


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16, nbytes / HBM_BW)


def experts_hit(c: dict, tokens: int) -> float:
    """Experts that `tokens` tokens are routed to, expected under uniform
    routing: E (1 - (1 - k / E) ** T).  The approximation the expert
    GEMMs' weight bytes are counted with (their reads of an expert that
    no token chose are not work the inputs need)."""
    e, k = c["n_experts"], c["n_experts_per_tok"]
    return e * (1.0 - (1.0 - k / e) ** tokens)


def call_gemm_least_s(c: dict, rows: int, head_rows: int) -> float:
    """Least time of every linear-layer GEMM of one model call over `rows`
    real (unpadded) token rows, the LM head over `head_rows` (fp32
    logits): attention projections, the MLP or the routed experts (weights
    of the experts hit, read once), summed over the layers.  The router
    (an fp32 product of d x E) is not a planned GEMM and is left out."""
    if rows <= 0:
        return 0.0
    d = c["d_model"]
    per_layer = sum(least_s(*gemm_cost(rows, k, n))
                    for k, n in attn_shapes(c))
    if is_moe(c):
        f, k = c["moe_d_ff"], c["n_experts_per_tok"]
        copies, hit = rows * k, experts_hit(c, rows)
        for k_in, n_out in ((d, f), (d, f), (f, d)):
            fl, _ = gemm_cost(copies, k_in, n_out)
            by = hit * k_in * n_out * BF16 + copies * (k_in + n_out) * BF16
            per_layer += least_s(fl, by)
    else:
        f = c["d_ff"]
        per_layer += sum(least_s(*gemm_cost(rows, k_in, n_out))
                         for k_in, n_out in ((d, f), (d, f), (f, d)))
    head = least_s(*gemm_cost(head_rows, d, c["vocab_size"],
                              out_bytes=FP32)) if head_rows else 0.0
    return c["n_layers"] * per_layer + head


def decode_attn_least_s(c: dict, rows: int, keys: int) -> float:
    """Least time of the attention of one decode step over `rows` rows
    that read `keys` cached positions between them (each row its own
    context, real positions only), summed over the layers: the scores and
    the weighted values, 4 x heads x head_dim operations a key, against
    the bf16 K and V of those keys, each row's q, its new k and v and its
    output.  Projections are the GEMMs' (`call_gemm_least_s`)."""
    if rows <= 0:
        return 0.0
    h, kv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    flops = 4.0 * h * hd * keys
    nbytes = float(2 * kv * hd * BF16 * keys
                   + rows * (2 * h * hd + 2 * kv * hd) * BF16)
    return c["n_layers"] * least_s(flops, nbytes)
