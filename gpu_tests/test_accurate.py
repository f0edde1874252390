"""Accuracy on the card: the software transcendentals (ops/accurate.py)
and the Bermudan brackets against their fp64 oracles and their CPU fp32
twins.  ops/accurate.exp32 exists because a hardware fp32 exp can carry
a mean bias that the bracket estimators compose; chip_smoke.py prints
the card's own exp error so a later change can decide whether it is
still needed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hullwhite_tpu import HWConfig
from hullwhite_tpu.instruments import swap_fixed_leg
from hullwhite_tpu.models import hull_white as hw, oracles
from hullwhite_tpu.ops.accurate import exp32, npdf

pytestmark = pytest.mark.gpu


def test_exp32_on_card_accuracy():
    """exp32 must be ~1 ulp and unbiased on the card."""
    x = np.random.default_rng(1).uniform(-12, 6, 8192).astype(np.float32)
    e = np.asarray(jax.jit(exp32)(jnp.asarray(x))).astype(np.float64)
    ref = np.exp(x.astype(np.float64))
    rel = (e - ref) / ref
    assert np.abs(rel).max() < 3e-7, np.abs(rel).max()   # ~2.5 ulp cap
    assert abs(rel.mean()) < 2e-8, rel.mean()            # unbiased


def test_npdf_on_card_accuracy():
    x = np.random.default_rng(2).uniform(-8, 8, 8192).astype(np.float32)
    p = np.asarray(jax.jit(npdf)(jnp.asarray(x))).astype(np.float64)
    ref = np.exp(-0.5 * x.astype(np.float64) ** 2) / np.sqrt(2 * np.pi)
    assert np.abs(p - ref).max() < 2e-7


def test_hw_bracket_against_dp_oracle():
    """The HW Bermudan bracket (k=5, 2^17 x 8 paths) sits within 1e-6 of
    the fp64 DP oracle on both sides and stays ordered up to 3 SE —
    chip_smoke.py's bermudan phase."""
    import chip_smoke

    g = chip_smoke.phase_bermudan(HWConfig(path_block=1 << 16),
                                  jax.random.key(0))
    assert g.ok, g.line()
    assert "lower_above_upper" in g.line()


def test_g2_bracket_platform_consistency():
    """G2++ Bermudan bracket: the fp32 evaluation on the card must match
    the in-process CPU fp32 twin (same fn, same key) within ~1e-6 on both
    sides (CPU fp32 is pinned vs the fp64 2-d DP oracle in the CPU
    suite)."""
    from hullwhite_tpu.models import g2pp

    cfg = HWConfig(path_block=1 << 16)
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    f = oracles.forward_rate(cfg, Ts)
    market = hw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32))
    sched = swap_fixed_leg(cfg, 0.025, 5.0)
    ex = [5.0, 6.0]
    g = g2pp.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)
    key = jax.random.key(cfg.seed)
    kw = dict(n_paths=1 << 15, n_blocks=4)
    res_t = g2pp.price_bermudan_g2(cfg, g, key, market, sched, ex, **kw)
    lo_t, up_t = float(res_t.price_cv), float(res_t.upper)
    with jax.default_device(jax.devices("cpu")[0]):
        res_c = g2pp.price_bermudan_g2(cfg, g, key, market, sched, ex,
                                       **kw)
        lo_c, up_c = float(res_c.price_cv), float(res_c.upper)
    assert abs(lo_t - lo_c) < 1.5e-6, (lo_t, lo_c)
    assert abs(up_t - up_c) < 1.5e-6, (up_t, up_c)
