"""Exotic layer on the GPU: CMS spread, range accrual, notes and caps
priced on the card against their fp64 oracles (the CPU suite already
pins these; this lane catches GPU-only compile/precision regressions —
cf. the fp32 exp/Phi ulp floor)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hullwhite_tpu import instruments, range_note, tiny_config
from hullwhite_tpu.models import hull_white as hw
from hullwhite_tpu.models import oracles

pytestmark = pytest.mark.gpu

CFG = tiny_config(n_paths=1 << 15, path_block=1 << 13, n_steps=1000)
KEY = jax.random.key(21)


@pytest.fixture(scope="module")
def market():
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    P = np.array([oracles.bond_price(CFG, T) for T in Ts])
    f = oracles.forward_rate(CFG, Ts)
    return hw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                          f=jnp.asarray(f, jnp.float32))


def test_cms_spread_on_gpu(market):
    kw = dict(strike=0.002, tenor=2.0, long_tenor=4.0, short_tenor=1.0)
    res = instruments.price_cms_spread(CFG, KEY, market, n_blocks=2, **kw)
    orc, _ = instruments.cms_spread_quadrature(CFG, market, **kw)
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 1e-5, (
        float(res.price), orc)


def test_range_accrual_on_gpu(market):
    kw = dict(coupon=0.03, lo=0.01, hi=0.022, tenor=3.0, obs_per_period=5)
    res = instruments.price_range_accrual(CFG, KEY, market, n_blocks=2, **kw)
    orc, _ = instruments.range_accrual_closed_form(CFG, market, **kw)
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 1e-5, (
        float(res.price), orc)


def test_range_note_on_gpu(market):
    """DP (host fp64) + MC policy run on the card; allow an e-6-scale
    fp32 exp ulp floor on top of MC noise."""
    kw = dict(coupon=0.03, lo=0.01, hi=0.022, tenor=3.0, obs_per_period=5)
    dp = range_note.dp_oracle_range_note(CFG, market, **kw)
    res = range_note.price_range_note(CFG, KEY, market, n_blocks=2,
                                      boundaries=dp.boundaries, **kw)
    assert abs(float(res.price) - dp.price) < 5 * float(res.std_error) + 1e-5
    assert float(res.std_error) < float(res.raw_std_error)


def test_snowball_and_floater_on_gpu(market):
    from hullwhite_tpu import floater, snowball

    skw = dict(initial=0.02, spread=0.013, cap=0.06, tenor=3.0)
    sdp = snowball.dp_oracle_snowball(CFG, market, **skw)
    sres = snowball.price_snowball(CFG, KEY, market, n_blocks=2, **skw)
    assert abs(float(sres.price) - sdp.price) \
        < 5 * float(sres.std_error) + 1e-5
    fkw = dict(cap=0.016, spread=0.004, tenor=3.0)
    fdp = floater.dp_oracle_capped_floater(CFG, market, **fkw)
    fres = floater.price_capped_floater(CFG, KEY, market, n_blocks=2,
                                        boundaries=fdp.boundaries, **fkw)
    assert abs(float(fres.price) - fdp.price) \
        < 5 * float(fres.std_error) + 1e-5


def test_g2_note_family_on_gpu(market):
    """The G2++ exotic twins compile and price on the card vs their fp64
    oracles at reduced grid sizes (the CPU suite pins the oracles; the
    measured O(h^2) bilinear convexity bias at (81,31,10) bounds the
    extra tolerance)."""
    from hullwhite_tpu import g2_note
    from hullwhite_tpu.models import g2pp

    g2 = g2pp.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)
    dpkw = dict(n_u=81, n_w=31, n_quad=10)
    nkw = dict(coupon=0.03, lo=0.01, hi=0.022, tenor=2.0,
               obs_per_period=4)
    dp = g2_note.dp_oracle_range_note_g2(CFG, g2, market, **nkw, **dpkw)
    res = g2_note.price_range_note_g2(CFG, g2, KEY, market, n_blocks=2,
                                      boundaries=dp.boundaries, **nkw)
    assert abs(float(res.price) - dp.price) \
        < 5 * float(res.std_error) + 2e-4
    tkw = dict(coupon=0.03, lo=0.01, hi=0.022, tenor=2.0, freq=1.0)
    tdp = g2_note.dp_oracle_tarn_g2(CFG, g2, market, target=0.045,
                                    **tkw, **dpkw)
    tres = g2_note.price_tarn_g2(CFG, g2, KEY, market, target=0.045,
                                 n_blocks=2, **tkw)
    assert abs(float(tres.price) - tdp.price) \
        < 5 * float(tres.std_error) + 2e-4
    skw = dict(initial=0.02, spread=0.013, cap=0.06, tenor=3.0)
    sdp = g2_note.dp_oracle_snowball_g2(CFG, g2, market, **skw,
                                        n_c=41, **dpkw)
    sres = g2_note.price_snowball_g2(CFG, g2, KEY, market, n_blocks=2,
                                     **skw)
    assert abs(float(sres.price) - sdp.price) \
        < 5 * float(sres.std_error) + 2e-4
    fkw = dict(cap=0.016, spread=0.004, tenor=3.0)
    fdp = g2_note.dp_oracle_capped_floater_g2(CFG, g2, market, **fkw,
                                              **dpkw)
    fres = g2_note.price_capped_floater_g2(CFG, g2, KEY, market,
                                           n_blocks=2,
                                           boundaries=fdp.boundaries,
                                           **fkw)
    assert abs(float(fres.price) - fdp.price) \
        < 5 * float(fres.std_error) + 2e-4


def test_cap_family_on_gpu(market):
    """Chooser/auto, ratchet and knock-out caps (HW + G2++ twins)
    compile and price on the card against their fp64 oracles."""
    from hullwhite_tpu import barrier, chooser, ratchet
    from hullwhite_tpu.models import g2pp

    g2 = g2pp.G2Params()
    ckw = dict(rate=0.013, k=2, tenor=3.0)
    cdp = chooser.dp_oracle_chooser_cap(CFG, market, **ckw)
    cres = chooser.price_chooser_cap(CFG, KEY, market, n_blocks=2, **ckw)
    assert abs(float(cres.price) - cdp.price) \
        < 5 * float(cres.std_error) + 1e-5
    gdp = chooser.dp_oracle_chooser_cap_g2(CFG, g2, market, **ckw)
    gres = chooser.price_chooser_cap_g2(CFG, g2, KEY, market, n_blocks=2,
                                        boundaries=gdp.boundaries, **ckw)
    assert abs(float(gres.price) - gdp.price) \
        < 5 * float(gres.std_error) + 3e-4
    rkw = dict(tenor=3.0)
    rq, _ = ratchet.ratchet_cap_quadrature(CFG, market, **rkw)
    rres = ratchet.price_ratchet_cap(CFG, KEY, market, n_blocks=2, **rkw)
    assert abs(float(rres.price) - rq) < 5 * float(rres.std_error) + 1e-5
    rq2, _ = ratchet.ratchet_cap_quadrature_g2(CFG, g2, market, **rkw)
    rres2 = ratchet.price_ratchet_cap_g2(CFG, g2, KEY, market,
                                         n_blocks=2, **rkw)
    assert abs(float(rres2.price) - rq2) \
        < 5 * float(rres2.std_error) + 1e-5
    kkw = dict(rate=0.013, barrier=0.05, tenor=3.0)
    kdp = barrier.dp_oracle_ko_cap(CFG, market, **kkw)
    kres = barrier.price_ko_cap(CFG, KEY, market, n_blocks=2, **kkw)
    assert abs(float(kres.price) - kdp.price) \
        < 5 * float(kres.std_error) + 1e-5
    kdp2 = barrier.dp_oracle_ko_cap_g2(CFG, g2, market, **kkw)
    kres2 = barrier.price_ko_cap_g2(CFG, g2, KEY, market, n_blocks=2,
                                    **kkw)
    assert abs(float(kres2.price) - kdp2.price) \
        < 5 * float(kres2.std_error) + 3e-4


def test_g2_callable_snowball_on_gpu(market):
    from hullwhite_tpu import g2_note
    from hullwhite_tpu.models import g2pp

    g2 = g2pp.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)
    skw = dict(initial=0.02, spread=0.013, cap=0.06, tenor=3.0)
    dp = g2_note.dp_oracle_callable_snowball_g2(
        CFG, g2, market, **skw, n_u=81, n_w=31, n_c=41, n_quad=10)
    res = g2_note.price_callable_snowball_g2(
        CFG, g2, KEY, market, n_blocks=2, boundaries=dp.boundaries,
        c_grid=dp.c_grid, plain_mean=dp.plain_price, **skw)
    assert abs(float(res.price) - dp.price) \
        < 5 * float(res.std_error) + 4e-4
