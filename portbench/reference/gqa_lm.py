"""Plain reference of a GQA decoder LM (dense SwiGLU or routed SwiGLU
experts), and the seeded weights both it and the port are given.

The equations, as the configuration states them:

    x      = E[tokens]                                  (no scaling)
    norm   = x * rsqrt(mean(x^2) + eps) * (1 + w)
    attn   = softmax(q k^T * head_dim^-0.5, causal) v over GQA groups,
             RoPE (theta, half-split rotation) on q and k at 0..S-1
    mlp    = (silu(h Wg) * (h Wu)) Wd
    moe    = sum over the top-k experts of softmax(h R) (renormalised
             over the k) times that expert's SwiGLU; no token is dropped
    x     += attn(norm1(x)); x += ffn(norm2(x)); logits = norm(x) E^T
             (tied) or norm(x) U.

Everything is computed in float32 with TF32 off, layer by layer over a
list of sequences, each on its own (no cache, no batching, no padding).
`precision="fp8"` is the control: every operand of every projection, the
experts and the LM head rounded to float8 e4m3 (a scale per row of the
activations and per column of the weights), the rest as in float32.

This file imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NORM_STD = 0.1        # the norms' weights enter as (1 + w)
EMBED_STD = 0.02
_ALIGN = 128          # elements: every leaf starts 256-byte aligned
_CHUNK = 1 << 30      # elements drawn per call


# ------------------------------------------------------------- weights
def leaf_specs(c: dict):
    """(path, shape, dtype, std) of every weight, in the layout the port
    reads: {"embed", "final_norm", ["unembed"], "stage0": [{"b0": {...}}
    a layer]}."""
    d, v = c["d_model"], c["vocab_size"]
    h, kv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    bf = torch.bfloat16
    yield ("embed",), (v, d), bf, EMBED_STD
    yield ("final_norm",), (d,), bf, NORM_STD
    if not c.get("tie_embeddings"):
        yield ("unembed",), (d, v), bf, d ** -0.5
    for layer in range(c["n_layers"]):
        b = ("stage0", layer, "b0")
        yield b + ("ln1",), (d,), bf, NORM_STD
        yield b + ("attn", "wq"), (d, h * hd), bf, d ** -0.5
        yield b + ("attn", "wk"), (d, kv * hd), bf, d ** -0.5
        yield b + ("attn", "wv"), (d, kv * hd), bf, d ** -0.5
        yield b + ("attn", "wo"), (h * hd, d), bf, (h * hd) ** -0.5
        yield b + ("ln2",), (d,), bf, NORM_STD
        if c.get("n_experts"):
            e, f = c["n_experts"], c["moe_d_ff"]
            yield b + ("moe", "router"), (d, e), torch.float32, d ** -0.5
            yield b + ("moe", "w_gate"), (e, d, f), bf, d ** -0.5
            yield b + ("moe", "w_up"), (e, d, f), bf, d ** -0.5
            yield b + ("moe", "w_down"), (e, f, d), bf, f ** -0.5
        else:
            f = c["d_ff"]
            yield b + ("mlp", "w_gate"), (d, f), bf, d ** -0.5
            yield b + ("mlp", "w_up"), (d, f), bf, d ** -0.5
            yield b + ("mlp", "w_down"), (f, d), bf, f ** -0.5


def check_supported(c: dict) -> None:
    if tuple(c["layer_pattern"]) not in (("attn_global",), ("attn_moe",)):
        raise ValueError(f"gqa_lm covers one global-attention layer kind, "
                         f"got {c['layer_pattern']}")
    for key, want in (("mlp_type", "swiglu"), ("attn_qkv_bias", False),
                      ("use_post_norm", False), ("embed_scale", False),
                      ("attn_softcap", 0.0), ("final_softcap", 0.0),
                      ("pos_embedding", "rope"), ("n_shared_experts", 0),
                      ("first_k_dense", 0)):
        if c.get(key, want) != want:
            raise ValueError(f"gqa_lm: {key}={c[key]!r} is not covered")


def make_weights(c: dict, seed: int, device) -> dict:
    """Every weight from `seed` on `device`: one buffer a dtype filled by
    a torch.Generator on the device in a few large calls, then scaled
    leaf by leaf (N(0, std^2) each, std as `leaf_specs`)."""
    check_supported(c)
    specs = list(leaf_specs(c))
    sizes: dict = {}
    offsets = []
    for _, shape, dt, _ in specs:
        off = sizes.get(dt, 0)
        offsets.append(off)
        n = math.prod(shape)
        sizes[dt] = off + -(-n // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = {}
    for dt in sorted(sizes, key=str):
        buf = torch.empty(sizes[dt], dtype=dt, device=device)
        for s in range(0, sizes[dt], _CHUNK):
            buf[s:s + _CHUNK].normal_(generator=gen)
        flat[dt] = buf
    tree: dict = {}
    for (path, shape, dt, std), off in zip(specs, offsets):
        t = flat[dt][off:off + math.prod(shape)].view(shape)
        t.mul_(std)
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = t
    return tree


# ------------------------------------------------------------ forward
def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _lin(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.float()
    if precision == "fp8":
        return _q8(x, -1) @ _q8(w, 0)
    return x @ w


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D): half-split rotation at positions 0..S-1."""
    s, _, dim = x.shape
    half = dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(x: torch.Tensor, p: dict, c: dict, precision: str):
    s = x.shape[0]
    h, kv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    q = _rope(_lin(x, p["wq"], precision).view(s, h, hd), c["rope_theta"])
    k = _rope(_lin(x, p["wk"], precision).view(s, kv, hd), c["rope_theta"])
    v = _lin(x, p["wv"], precision).view(s, kv, hd)
    group = h // kv
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    ctx = torch.empty(s, h, hd, device=x.device)
    for j in range(kv):                     # one kv head and its q heads
        qj = q[:, j * group:(j + 1) * group].transpose(0, 1)  # (G, S, D)
        sc = qj @ k[:, j].T * hd ** -0.5
        sc = sc.masked_fill(~mask, float("-inf")).softmax(-1)
        ctx[:, j * group:(j + 1) * group] = (sc @ v[:, j]).transpose(0, 1)
    return _lin(ctx.reshape(s, h * hd), p["wo"], precision)


def _mlp(x, p, precision):
    g = _lin(x, p["w_gate"], precision)
    u = _lin(x, p["w_up"], precision)
    return _lin(F.silu(g) * u, p["w_down"], precision)


def _moe(xs: list, p: dict, c: dict, precision: str) -> list:
    """The routed experts over every sequence's rows at once (routing is
    per token, so batching the rows changes nothing): dropless."""
    x = torch.cat(xs)
    k = c["n_experts_per_tok"]
    probs = (x @ p["router"].float()).softmax(-1)
    w, idx = probs.topk(k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(x)
    for e in range(c["n_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        pe = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
        y.index_add_(0, rows, _mlp(x[rows], pe, precision)
                     * w[rows, slot, None])
    return list(y.split([t.shape[0] for t in xs]))


def _layers(c: dict, w: dict):
    for layer in w["stage0"]:
        yield layer["b0"]


@torch.no_grad()
def final_hidden(c: dict, w: dict, seqs: list[list[int]],
                 precision: str = "fp32") -> list[torch.Tensor]:
    """The normed final hidden states (S_i, d) fp32 of each sequence."""
    dev = w["embed"].device
    eps = c["norm_eps"]
    xs = [w["embed"][torch.tensor(s, device=dev)].float() for s in seqs]
    for p in _layers(c, w):
        xs = [x + _attention(_norm(x, p["ln1"], eps), p["attn"], c,
                             precision) for x in xs]
        hs = [_norm(x, p["ln2"], eps) for x in xs]
        if "moe" in p:
            ys = _moe(hs, p["moe"], c, precision)
        else:
            ys = [_mlp(h, p["mlp"], precision) for h in hs]
        xs = [x + y for x, y in zip(xs, ys)]
    return [_norm(x, w["final_norm"], eps) for x in xs]


def head_weight(c: dict, w: dict) -> torch.Tensor:
    """The LM head as (V, d) rows."""
    return w["embed"] if c.get("tie_embeddings") else w["unembed"].T


@torch.no_grad()
def logit_rows(c: dict, w: dict, h: torch.Tensor, precision: str = "fp32",
               vocab_chunk: int = 32768):
    """Yield (v0, logits (n, chunk) fp32) over vocabulary chunks of the
    LM head applied to rows h (n, d)."""
    head = head_weight(c, w)
    hq = h if precision == "fp32" else _q8(h, -1)
    for v0 in range(0, head.shape[0], vocab_chunk):
        rows = head[v0:v0 + vocab_chunk].float()
        if precision == "fp8":
            rows = _q8(rows, -1)
        yield v0, hq @ rows.T


@torch.no_grad()
def best_and_picked(c: dict, w: dict, h: torch.Tensor, picked: torch.Tensor,
                    precision: str = "fp32"):
    """For rows h (n, d): each row's largest logit, its argmax, and the
    logit of `picked` (n,) token ids; all at `precision`."""
    n = h.shape[0]
    best = torch.full((n,), float("-inf"), device=h.device)
    arg = torch.zeros(n, dtype=torch.long, device=h.device)
    got = torch.zeros(n, device=h.device)
    for v0, lg in logit_rows(c, w, h, precision):
        m, i = lg.max(-1)
        better = m > best
        best = torch.where(better, m, best)
        arg = torch.where(better, i + v0, arg)
        inside = (picked >= v0) & (picked < v0 + lg.shape[1])
        col = (picked - v0).clamp(0, lg.shape[1] - 1)
        got = torch.where(inside, lg.gather(1, col[:, None])[:, 0], got)
    return best, arg, got


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
