"""The chunk-parallel walks of K6 (RG-LRU scan) and K8 (SSD scan), on the CPU.

* K6: `rglru_scan.rglru_config` fits shared memory, lays out all 256
  threads, covers every (batch row, step, channel) exactly once and
  fills 78-, 114- and 132-SM cards at recurrentgemma-9b's 4 x 128 x 4096
  and 1 x 3072 x 4096 prefills; a torch mirror of the kernel's walk
  (per block, each segment's composite from (1, 0), the carry folded
  through the earlier segments' composites in order, each segment's
  re-walk, the last segment's h carried on) matches the port's plain
  version and the JAX package's `ref.rglru_ref`.
* K8: `ssd_scan.ssd_config` fits shared memory (two readout CTAs and two
  chunk-state CTAs an SM at mamba2-2.7b's bf16 shapes), covers every (b,
  step, head, p) of y, every (b, head, chunk, s, p) of the chunk states,
  every element of the state-pass plane and, with one chunk, every 64-row
  block of S of the fused state exactly once, and fills the cards at
  mamba2's 4 x 128 and 1 x 3000 prefills; the 64 x 64 product tile's
  thread layout covers it once; a torch mirror of the three kernels in
  their order (chunk states, state pass, readout by 64-row strips; the
  readout alone from a zero state for one chunk) matches the port's plain
  version and the JAX package's `ref.ssd_ref`.

Tolerances: the mirrors run the plain versions' fp32 arithmetic in another
association, so they hold the plain versions at 1e-5 relative to the
largest magnitude; against the JAX oracles (sequential fp32 recurrences)
at rtol = atol = 1e-5, and at 1e-3 under the strong decay, as
tests/test_torch_ssd.py holds the plain SSD version there (the fp32
recurrence multiplies thousands of per-step decays of e^-100).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd

SMS = (78, 114, 132)
SMEM_MAX = 232448          # shared memory a block may use on sm_90
REL = 1e-5
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL_STRONG = dict(rtol=1e-3, atol=1e-3)


def _close(got: torch.Tensor, want: torch.Tensor, rel: float = REL) -> None:
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * max(scale, 1e-30), (err, scale)


# ------------------------------------------------------------------ K6
RG_ROWS = {"recurrentgemma_b4_p128": (4, 128, 4096),
           "recurrentgemma_b1_p3072": (1, 3072, 4096)}


def _rg_inputs(b, length, d, seed, strong=False):
    rng = np.random.default_rng(seed)
    x, r, i = (rng.normal(size=(b, length, d)).astype(np.float32)
               for _ in range(3))
    lam = rng.uniform(-2, 2, size=(d,)).astype(np.float32)
    if strong:              # sigmoid(r) ~ 1 and softplus(4) ~ 4: a ~ e^-32
        r, lam = np.full_like(r, 5.0), np.full_like(lam, 4.0)
    return x, r, i, lam


def rglru_walk(x, r, i, lam, cfg: rg.RglruConfig, c: float = 8.0):
    """K6's walk in PyTorch, in the kernel's order: per block of nseg * t
    steps, every segment's composite (prod a, h from zero) of its t steps;
    segment k's incoming h is the carry folded through the composites of
    segments 0 .. k-1 in order; each segment re-walks its steps from it;
    the last segment's h is the carry into the next block."""
    log_a = -c * torch.sigmoid(r) * torch.nn.functional.softplus(lam)
    a = torch.exp(log_a)
    bt = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (torch.sigmoid(i) * x)
    bsz, length, d = x.shape
    y = torch.empty_like(x)
    carry = torch.zeros((bsz, d))
    for t0 in range(0, length, cfg.nseg * cfg.t):
        steps = [range(t0 + k * cfg.t, min(t0 + (k + 1) * cfg.t, length))
                 for k in range(cfg.nseg)]
        comps = []
        for seg in steps:
            ca, cb = torch.ones((bsz, d)), torch.zeros((bsz, d))
            for t in seg:
                cb = a[:, t] * cb + bt[:, t]
                ca = a[:, t] * ca
            comps.append((ca, cb))
        h_in = carry
        for seg, (ca, cb) in zip(steps, comps):
            h = h_in
            for t in seg:
                h = a[:, t] * h + bt[:, t]
                y[:, t] = h
            h_in = ca * h_in + cb
        carry = h
    return y, carry


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("vec", [1, 2])
@pytest.mark.parametrize("row", list(RG_ROWS))
def test_rglru_config_fits_and_fills_the_card(row, vec, sms):
    b, length, d = RG_ROWS[row]
    cfg = rg.rglru_config(b, length, d, vec, sms)
    assert cfg.ch in rg.CHANNEL_TILES and cfg.ch % vec == 0
    assert cfg.tpr * cfg.vec == cfg.ch and cfg.tpr * cfg.nseg == rg.THREADS
    assert 1 <= cfg.t <= rg.T_MAX
    assert cfg.smem <= 48 * 1024 <= SMEM_MAX       # static shared memory
    assert cfg.grid[0] * cfg.grid[1] >= sms


def test_rglru_config_takes_the_widest_tile_that_fills_the_card():
    assert rg.rglru_config(4, 128, 4096, 2, 132).ch == 32
    assert rg.rglru_config(1, 3072, 4096, 2, 132).ch == 16
    assert rg.rglru_config(1, 3072, 4096, 2, 114).ch == 32
    # one block of 128 steps at the batch-4 prefill
    cfg = rg.rglru_config(4, 128, 4096, 2, 132)
    assert cfg.nseg * cfg.t >= 128


def _rg_cover(b, length, d, cfg) -> np.ndarray:
    """How often the kernel's threads store each (b, step, channel)."""
    count = np.zeros((b, length, d), dtype=np.int64)
    tid = np.arange(rg.THREADS)
    seg, cl = tid // cfg.tpr, tid % cfg.tpr
    for bx in range(cfg.grid[0]):
        for v in range(cfg.vec):
            dd = bx * cfg.ch + cl * cfg.vec + v
            for t0 in range(0, length, cfg.nseg * cfg.t):
                for u in range(cfg.t):
                    t = t0 + seg * cfg.t + u
                    ok = (dd < d) & (t < length)
                    np.add.at(count, (slice(None), t[ok], dd[ok]), 1)
    return count


@pytest.mark.parametrize("shape,vec", [((2, 37, 200), 2), ((1, 300, 201), 1),
                                       ((3, 1, 64), 2), ((1, 700, 96), 1),
                                       ((2, 513, 48), 2)])
def test_rglru_walk_covers_every_step_once(shape, vec):
    for sms in SMS:
        cfg = rg.rglru_config(*shape, vec, sms)
        assert (_rg_cover(*shape, cfg) == 1).all()


@pytest.mark.parametrize("shape,vec", [((2, 37, 24), 2), ((1, 300, 17), 1),
                                       ((3, 1, 8), 2), ((2, 129, 16), 1)])
def test_rglru_walk_matches_the_plain_version(shape, vec):
    x, r, i, lam = (torch.from_numpy(a) for a in _rg_inputs(*shape, seed=3))
    cfg = rg.rglru_config(*shape, vec, 132)
    y, h = rglru_walk(x, r, i, lam, cfg)
    want, hw = rg.rglru_scan_plain(x, r, i, lam, return_state=True)
    _close(y, want)
    _close(h, hw)


@pytest.mark.parametrize("case", ["L1", "ragged", "strong_decay", "long"])
def test_rglru_walk_matches_the_jax_oracle(case):
    shape, strong = {"L1": ((2, 1, 16), False), "ragged": ((3, 77, 24), False),
                     "strong_decay": ((2, 200, 16), True),
                     "long": ((1, 600, 8), False)}[case]
    arrays = _rg_inputs(*shape, seed=11, strong=strong)
    cfg = rg.rglru_config(*shape, 2, 132)
    y, h = rglru_walk(*(torch.from_numpy(a) for a in arrays), cfg)
    jy, jh = jref.rglru_ref(*(jnp.asarray(a) for a in arrays),
                            return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **JAX_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **JAX_TOL)


# ------------------------------------------------------------------ K8
SSD_ROWS = {"mamba2_b4_p128": (4, 128, 80, 64, 1, 128),
            "mamba2_b1_p3000": (1, 3000, 80, 64, 1, 128)}


def _ssd_inputs(b, length, h, p, g, s, seed, strong=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, length, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.2, size=(b, length, h)).astype(np.float32)
    a_log = rng.uniform(-0.5, 1.0, size=(h,)).astype(np.float32)
    if strong:              # A = -e^3, dt up to 5: a step decays by e^-100
        dt, a_log = dt * 25.0, np.full_like(a_log, 3.0)
    bm = (rng.normal(size=(b, length, g, s)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, length, g, s)) * 0.5).astype(np.float32)
    return x, dt, a_log, bm, cm


def tile_layout(ak: bool, bk: bool) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of `fma_tile`'s 4 x 4 sums for each of 256 threads."""
    tid = np.arange(ssd.THREADS)
    w, lane = tid // 32, tid % 32
    ty, tx = lane // 8, lane % 8
    r, c = np.arange(4), np.arange(4)
    rows = 16 * (w >> 1)[:, None] + (4 * ty[:, None] + r if ak
                                     else ty[:, None] + 4 * r)
    cols = 32 * (w & 1)[:, None] + (4 * tx[:, None] + c if bk
                                    else tx[:, None] + 8 * c)
    return rows, cols


@pytest.mark.parametrize("ak", [True, False])
@pytest.mark.parametrize("bk", [True, False])
def test_ssd_product_tile_covers_64_by_64_once(ak, bk):
    rows, cols = _pairs(*tile_layout(ak, bk))
    count = np.zeros((64, 64), dtype=np.int64)
    np.add.at(count, (rows, cols), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_config_fits_shared_memory(dtype):
    cfg = ssd.ssd_config(4, 128, 80, 64, 128, 128, dtype)
    assert cfg.readout_smem <= SMEM_MAX
    assert cfg.chunk_state_smem <= SMEM_MAX
    assert cfg.chunk_state_per_sm >= 2
    if dtype == torch.bfloat16:     # mamba2's inputs: two readout CTAs an SM
        assert cfg.readout_per_sm >= 2
        assert 2 * (cfg.readout_smem + ssd.CTA_RESERVED) <= ssd.SM_SMEM


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("row", list(SSD_ROWS))
def test_ssd_config_fills_the_card(row, sms):
    b, length, h, p, _, s = SSD_ROWS[row]
    cfg = ssd.ssd_config(b, length, h, p, s, 128, torch.bfloat16)
    # at least one full wave of every kernel the row launches
    assert cfg.readout[0] * cfg.readout[1] >= cfg.readout_per_sm * sms
    if cfg.chunk_state is not None:
        assert cfg.chunk_state[0] * cfg.chunk_state[1] >= \
            cfg.chunk_state_per_sm * sms
        assert cfg.state_pass[0] * cfg.state_pass[1] * cfg.state_pass[2] \
            * ssd.PASS_THREADS >= sms * 256


def test_ssd_config_at_mamba2():
    one = ssd.ssd_config(4, 128, 80, 64, 128, 128, torch.bfloat16)
    assert (one.nc, one.strips, one.readout) == (1, 2, (160, 4))
    assert one.chunk_state is None and one.ws_shape is None
    long = ssd.ssd_config(1, 3000, 80, 64, 128, 128, torch.bfloat16)
    assert (long.nc, long.ncs) == (24, 24)
    assert long.readout == (3840, 1) and long.chunk_state == (3840, 1)
    assert long.ws_shape == (1, 80, 24, 128, 64)
    no_state = ssd.ssd_config(1, 3000, 80, 64, 128, 128, torch.bfloat16,
                              return_state=False)
    assert no_state.ncs == 23 and no_state.chunk_state == (3680, 1)


def mma_layout() -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of the bf16 route's 64 x 64 MMA tile (`mma_tile`: warp
    w on rows 16 (w & 3) .. + 16 and columns 32 (w >> 2) .. + 32; element e
    of its m16n8 accumulator t at row lane / 4 + 8 (e >> 1), column 8 t +
    2 (lane % 4) + e % 2), flattened over threads, t and e."""
    tid = np.arange(ssd.THREADS)[:, None, None]
    t, e = np.arange(4)[None, :, None], np.arange(4)[None, None, :]
    w, lane = tid // 32, tid % 32
    rows = 16 * (w & 3) + lane // 4 + 8 * (e >> 1) + 0 * t
    cols = 32 * (w >> 2) + 8 * t + 2 * (lane % 4) + (e & 1)
    return rows.ravel(), cols.ravel()


def test_ssd_mma_tile_covers_64_by_64_once():
    rows, cols = mma_layout()
    count = np.zeros((64, 64), dtype=np.int64)
    np.add.at(count, (rows, cols), 1)
    assert (count == 1).all()


def _pairs(rows: np.ndarray, cols: np.ndarray) -> tuple:
    """Every thread's 16 (row, col) sums, flattened."""
    return (np.repeat(rows, 4, axis=1).ravel(),
            np.broadcast_to(cols[:, None, :], (len(cols), 4, 4)).reshape(-1))


def _ssd_cover(b, length, h, p, s, chunk, return_state, dtype):
    """How often the three kernels store each output element (the bf16
    route stores its MMA tiles, the fp32 route its FMA tiles)."""
    cfg = ssd.ssd_config(b, length, h, p, s, chunk, dtype, return_state)
    mma = dtype == torch.bfloat16
    y = np.zeros((b, length, h, p), dtype=np.int64)
    rr, cc = mma_layout() if mma else _pairs(*tile_layout(False, True))
    for bx in range(cfg.readout[0]):
        strip, t = bx % cfg.strips, bx // cfg.strips
        hh, c = t % h, t // h
        c0 = c * cfg.q
        i0 = strip * ssd.STRIP
        nrows = min(ssd.STRIP, min(cfg.q, length - c0) - i0)
        ok = (rr < nrows) & (cc < p)
        np.add.at(y, (slice(None), c0 + i0 + rr[ok], hh, cc[ok]), 1)
    st = np.zeros((b, h, cfg.nc, s, cfg.ldp), dtype=np.int64)
    fused = np.zeros((b, h, s, p), dtype=np.int64)
    kr, kc = mma_layout() if mma else _pairs(*tile_layout(True, True))
    if cfg.chunk_state is not None:
        for bx in range(cfg.chunk_state[0]):
            sb, t = bx % cfg.s_blocks, bx // cfg.s_blocks
            hh, c = t % h, t // h
            ss = sb * ssd.S_BLOCK + kr
            ok = (ss < s) & (kc < cfg.ldp)
            np.add.at(st, (slice(None), hh, c, ss[ok], kc[ok]), 1)
        plane = np.zeros((b, h, s * cfg.ldp // 4), dtype=np.int64)
        for bx in range(cfg.state_pass[0]):
            e4 = bx * ssd.PASS_THREADS + np.arange(ssd.PASS_THREADS)
            e4 = e4[e4 < s * cfg.ldp // 4]
            plane[:, :, e4] += 1
        assert (plane == 1).all()
    elif return_state:
        for bx in range(cfg.readout[0]):
            strip, hh = bx % cfg.strips, (bx // cfg.strips) % h
            for sb in range(strip, cfg.s_blocks, cfg.strips):
                ss = sb * ssd.S_BLOCK + kr
                ok = (ss < s) & (kc < p)
                np.add.at(fused, (slice(None), hh, ss[ok], kc[ok]), 1)
        assert (fused == 1).all()
    return cfg, y, st


@pytest.mark.parametrize("shape", [
    (4, 128, 80, 64, 128, 128), (1, 3000, 8, 64, 128, 128),
    (2, 200, 16, 64, 64, 128), (3, 77, 6, 40, 72, 48), (1, 5, 2, 3, 5, 2),
    (2, 37, 3, 16, 16, 128), (1, 1, 2, 8, 100, 128),
    (2, 256, 4, 64, 128, 128)])
@pytest.mark.parametrize("return_state", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_grids_cover_every_output_once(shape, return_state, dtype):
    cfg, y, st = _ssd_cover(*shape, return_state, dtype)
    assert (y == 1).all()
    if cfg.chunk_state is not None:
        assert (st[:, :, :cfg.ncs] == 1).all() and \
            (st[:, :, cfg.ncs:] == 0).all()


def ssd_walk(x, dt, a_log, bm, cm, *, chunk: int, return_state: bool):
    """K8's three kernels in PyTorch, in their order: every chunk's dS and
    decay on its own (all chunks with the state returned, else all but the
    last), the state pass over the chunks (state_c = state_{c-1} * decay_c
    + dS_c), then the readout by 64-row strips, y = (C B^T o decay)(x dt) +
    exp(cum) (C state_{c-1}) with the scores only up to the strip's last
    row; with one chunk the readout alone, its state dS_0."""
    bsz, length, h, p = x.shape
    g, s = bm.shape[2], bm.shape[3]
    cfg = ssd.ssd_config(bsz, length, h, p, s, chunk, torch.float32,
                         return_state)
    q, nc = cfg.q, cfg.nc
    neg_a = -torch.exp(a_log)
    bq = bm.repeat_interleave(h // g, dim=2)
    cq = cm.repeat_interleave(h // g, dim=2)
    xd = x * dt[..., None]

    def cum_of(c):
        c0, c1 = c * q, min(c * q + q, length)
        return c0, c1, torch.cumsum((dt[:, c0:c1] * neg_a).double(), dim=1)

    incoming = [torch.zeros((bsz, h, s, p))] * nc
    state = None
    if nc > 1:
        ds, dec = [], []
        for c in range(cfg.ncs):                        # kernel 1
            c0, c1, cum = cum_of(c)
            w = torch.exp((cum[:, -1:] - cum).float())[..., None]
            ds.append(torch.einsum("bjhs,bjhp->bhsp", bq[:, c0:c1],
                                   xd[:, c0:c1] * w))
            dec.append(torch.exp(cum[:, -1].float()))
        st = torch.zeros((bsz, h, s, p))                # kernel 2
        for c in range(nc):
            incoming[c] = st
            if c < cfg.ncs:
                st = st * dec[c][..., None, None] + ds[c]
        state = st if return_state else None
    y = torch.empty_like(x)
    for c in range(nc):                                 # kernel 3
        c0, c1, cum = cum_of(c)
        for i0 in range(0, c1 - c0, ssd.STRIP):
            i1 = min(i0 + ssd.STRIP, c1 - c0)
            ci, cj = cum[:, i0:i1], cum[:, :i1]
            sc = torch.einsum("bihs,bjhs->bijh", cq[:, c0 + i0:c0 + i1],
                              bq[:, c0:c0 + i1])
            diff = (ci[:, :, None] - cj[:, None]).float()
            keep = (torch.arange(i0, i1)[:, None]
                    >= torch.arange(i1)[None, :])[None, :, :, None]
            sc = torch.where(keep, sc * torch.exp(torch.where(
                keep, diff, torch.zeros_like(diff))), torch.zeros_like(sc))
            yi = torch.einsum("bijh,bjhp->bihp", sc, xd[:, c0:c0 + i1])
            ys = torch.einsum("bihs,bhsp->bihp", cq[:, c0 + i0:c0 + i1],
                              incoming[c])
            y[:, c0 + i0:c0 + i1] = yi + torch.exp(ci.float())[..., None] * ys
        if nc == 1 and return_state:
            w = torch.exp((cum[:, -1:] - cum).float())[..., None]
            state = torch.einsum("bjhs,bjhp->bhsp", bq, xd * w)
    return (y, state) if return_state else y


@pytest.mark.parametrize("case", [
    ("one chunk", (2, 100, 4, 16, 1, 32), 128, False),
    ("two chunks", (2, 256, 4, 16, 2, 32), 128, False),
    ("ragged tail", (1, 300, 2, 8, 1, 16), 128, False),
    ("odd sizes", (3, 77, 6, 40, 3, 72), 48, False),
    ("P 3, S 5, chunk 2", (1, 5, 2, 3, 1, 5), 2, False),
    ("strong decay", (2, 200, 4, 16, 2, 16), 64, True)], ids=lambda c: c[0])
@pytest.mark.parametrize("return_state", [True, False])
def test_ssd_walk_matches_the_plain_version(case, return_state):
    _, shape, chunk, strong = case
    args = [torch.from_numpy(a) for a in _ssd_inputs(*shape, seed=5,
                                                     strong=strong)]
    got = ssd_walk(*args, chunk=chunk, return_state=return_state)
    want = ssd.ssd_scan_plain(*args, chunk=chunk, return_state=return_state)
    if return_state:
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        _close(got, want)


@pytest.mark.parametrize("case", [
    ("L1", (2, 1, 4, 8, 1, 8), 128, False),
    ("ragged tail", (2, 77, 4, 8, 2, 8), 32, False),
    ("groups", (1, 64, 6, 8, 3, 16), 16, False),
    ("strong decay", (2, 100, 4, 8, 1, 8), 32, True)], ids=lambda c: c[0])
def test_ssd_walk_matches_the_jax_oracle(case):
    _, shape, chunk, strong = case
    arrays = _ssd_inputs(*shape, seed=9, strong=strong)
    y, st = ssd_walk(*(torch.from_numpy(a) for a in arrays), chunk=chunk,
                     return_state=True)
    jy, jst = jref.ssd_ref(*(jnp.asarray(a) for a in arrays),
                           return_state=True)
    tol = JAX_TOL_STRONG if strong else JAX_TOL
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(st.numpy(),
                               np.swapaxes(np.asarray(jst), -1, -2), **tol)


@pytest.mark.parametrize("return_state", [True, False])
def test_ssd_plain_pieces_compose_to_the_plain_scan(return_state):
    """The chunk-state and state-pass plain pieces (the card's check of the
    first two kernels) give the plain scan's state."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(2, 300, 4, 8, 2, 16,
                                                     seed=2)]
    cfg = ssd.ssd_config(2, 300, 4, 8, 16, 64, torch.float32, return_state)
    ds, dec = ssd.ssd_chunk_state_plain(*args[:4], chunk=64, ncs=cfg.ncs)
    assert ds.shape == (2, 4, cfg.ncs, 16, 8) and dec.shape == (2, 4, cfg.ncs)
    incoming, st = ssd.ssd_state_pass_plain(ds, dec, cfg.nc)
    assert incoming.shape == (2, 4, cfg.nc, 16, 8)
    assert (incoming[:, :, 0] == 0).all()
    if return_state:
        _, want = ssd.ssd_scan_plain(*args, chunk=64, return_state=True)
        _close(st, want)
