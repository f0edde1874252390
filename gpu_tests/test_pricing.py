"""The Q1 -> Q2 -> Q3 path on the card: each test runs the same function
as its chip_smoke.py phase, at the reference's full size."""

import jax
import pytest

import chip_smoke
from hullwhite_tpu import HWConfig, pricing

pytestmark = pytest.mark.gpu

CFG = HWConfig()
KEY = jax.random.key(CFG.seed)


@pytest.fixture(scope="module")
def market():
    gate, m = chip_smoke.phase_curve(CFG, KEY)
    assert gate.ok, gate.line()
    return m


def test_curve_against_oracle_and_published(market):
    assert float(market.P[0]) == 1.0


def test_theta_recovery_and_zbc(market):
    g = chip_smoke.phase_q2(CFG, KEY, market)
    assert g.ok, g.line()


def test_vega_against_oracle_and_fd(market):
    g = chip_smoke.phase_q3(CFG, KEY, market)
    assert g.ok, g.line()


def test_gpu_equals_cpu_on_exact_and_linear():
    g = chip_smoke.phase_gpu_vs_cpu(CFG.replace(n_paths=1 << 16))
    assert g.ok, g.line()


@pytest.mark.parametrize("precision", ["tensorfloat32", "default"])
def test_gpu_vs_cpu_phase_fails_on_tf32(precision):
    """The control: with the card's matmuls allowed TF32 the phase must
    fail, on every per-path row."""
    g = chip_smoke.phase_gpu_vs_cpu(CFG.replace(n_paths=1 << 16),
                                    gpu_precision=precision)
    assert not g.ok, g.line()
    failed = {name for name, *_, ok in g.rows if not ok}
    assert {f"{e}_path_{r}_max_rel" for e in ("exact", "linear")
            for r in ("legs", "state")} <= failed, g.line()


def test_engine_cross_agreement(market):
    """exact and linear agree on the ZBC price within MC noise (they draw
    different streams) — the reference's cross-kernel consistency gate
    (benchmark_reductions.cu:158-169) at a statistical tolerance."""
    cfg = CFG.replace(n_paths=1 << 18, path_block=1 << 16)
    prices = [float(pricing.price_zbc(cfg, KEY, market, engine=e).price)
              for e in ("exact", "linear")]
    assert abs(prices[0] - prices[1]) < 8e-4, prices
