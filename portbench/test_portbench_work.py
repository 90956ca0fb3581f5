"""The frozen operation and byte counts of `portbench/work/gqa_lm.py`
against numbers worked out by hand for both configurations."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from pbcore import manifest  # noqa: E402

MAN = manifest.load_manifest()
WORK = manifest.load_module("work", "gqa_lm")
PHI4 = manifest.load_config(MAN, "phi4-mini-3.8b")
DBRX = manifest.load_config(MAN, "dbrx-132b-8of40")


# phi4-mini: a layer is q 3072^2 + k, v 2 x 3072 x 1024 + o 3072^2 + two
# norms 2 x 3072 + SwiGLU 3 x 3072 x 8192 = 100,669,440; 32 layers, the
# final norm and the tied head 200064 x 3072 give N = 3,836,021,760.
# dbrx at 8 layers: attention 88,080,384 + norms 12,288 + router 98,304 +
# 4 of 16 experts (3 x 6144 x 10752 each) 792,723,456 = 880,914,432 a
# layer; with the final norm and the untied head 6144 x 100352,
# N = 7,663,884,288.
@pytest.mark.parametrize("cfg,per_token", [(PHI4, 7_672_043_520),
                                           (DBRX, 15_327_768_576)])
def test_forward_flops_per_token(cfg, per_token):
    assert WORK.model_flops(cfg, 1) == per_token
    assert WORK.model_flops(cfg, 1000, "train") == 3 * 1000 * per_token


def test_layer_params_by_hand():
    assert WORK.layer_params(PHI4) == (100_669_440, 100_669_440)
    assert WORK.layer_params(DBRX) == (3_259_084_800, 880_914_432)


def test_phi4_decode_least_time_by_hand():
    # 32 rows: every product is bound by its bytes (32 flop a byte, far
    # under the card's 295).  A layer: 2 x 100,663,296 weight bytes + 2 x
    # 32 x (26,624 in + 27,648 out) = 204,800,000; 32 layers; the head
    # 2 x 3072 x 200064 + 2 x 32 x 3072 + 4 x 32 x 200064 = 1,254,998,016.
    want = (32 * 204_800_000 + 1_254_998_016) / 3.35e12
    assert WORK.call_gemm_least_s(PHI4, 32, 32) == pytest.approx(want,
                                                                 rel=1e-12)


def test_phi4_prefill_least_time_by_hand():
    # 1024 rows, head on 1: q / o 2 x 1024 x 3072^2 = 19.33 GFLOP against
    # 18.87 MB + 12.58 MB: bound by operations; k / v 6.44 GFLOP, 6.29 MB +
    # 6.29 MB + 2.10 MB; the MLP's three 51.54 GFLOP each: all by
    # operations (at 1024 rows a product reads >= 340 flop a byte)
    flops = 2 * 1024 * (2 * 3072 * 3072 + 2 * 3072 * 1024 + 3 * 3072 * 8192)
    head = (2 * 3072 * 200064 + 2 * 3072 + 4 * 200064) / 3.35e12
    want = 32 * flops / 989e12 + head
    assert WORK.call_gemm_least_s(PHI4, 1024, 1) == pytest.approx(want,
                                                                  rel=1e-12)


def test_dbrx_decode_least_time_by_hand():
    # 32 rows, every product bound by bytes.  Projections: 2 x 88,080,384
    # weight bytes, and 2 x 32 x (24,576 in + 14,336 out).  The experts
    # hit are 16 (1 - 0.75^32) = 15.998; their three products read hit x
    # 6144 x 10752 x 2 each, and the 128 routed copies 2 x 128 x (6144 +
    # 10752) in and out.
    hit = 16 * (1 - 0.75 ** 32)
    attn = 2 * 88_080_384 + 64 * (24_576 + 14_336)
    experts = 3 * (hit * 6144 * 10752 * 2 + 128 * (6144 + 10752) * 2)
    head = 2 * 6144 * 100352 + 2 * 32 * 6144 + 4 * 32 * 100352
    want = (8 * (attn + experts) + head) / 3.35e12
    assert WORK.experts_hit(DBRX, 32) == pytest.approx(hit, rel=1e-12)
    assert WORK.call_gemm_least_s(DBRX, 32, 32) == pytest.approx(want,
                                                                 rel=1e-12)


def test_frozen_flops_equal_the_port_today():
    """The port's own count agrees today; a later change to it leaves the
    frozen copy as it is."""
    sys.path.insert(0, str(BENCH.parent / "src"))
    drv = manifest.load_module("drivers", "serve_stream")
    from repro_torch.models.model import model_flops
    for cfg in (PHI4, DBRX):
        assert model_flops(drv.port_config(cfg), tokens=7,
                           mode="forward") == WORK.model_flops(cfg, 7)


@pytest.mark.parametrize("cfg,layers,heads", [(PHI4, 32, 24), (DBRX, 8, 48)])
def test_decode_attention_least_time_by_hand(cfg, layers, heads):
    # 32 rows over 12,800 cached keys: 4 x heads x 128 operations a key
    # against 2 x 8 x 128 x 2 bytes of K and V a key and, a row, q and the
    # output (2 x heads x 128 x 2) with the new k and v (2 x 8 x 128 x 2):
    # bound by bytes (at most 1.5 flop a byte)
    nbytes = 4096 * 12_800 + 32 * (4 * heads * 128 + 4096)
    assert 4 * heads * 128 * 12_800 / 989e12 < nbytes / 3.35e12
    want = layers * nbytes / 3.35e12
    assert WORK.decode_attn_least_s(cfg, 32, 12_800) == pytest.approx(
        want, rel=1e-12)
    assert WORK.decode_attn_least_s(cfg, 0, 0) == 0.0
