"""Cross-engine consistency: the scan engine and the linear (matmul) engine
must agree pathwise on identical shocks — the analogue of the
reference's <1e-6 reduction-variant price agreement
(benchmark_reductions.cu:158-169), but stronger (per-path, not just means).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hullwhite_tpu import tiny_config
from hullwhite_tpu.models import hull_white as hw
from hullwhite_tpu.ops import engine_linear, engine_scan


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    tables = hw.step_tables(cfg, cfg.sigma)
    G = jax.random.normal(jax.random.key(7), (256, cfg.n_steps), jnp.float32)
    return cfg, tables, G


def test_antithetic_state_agreement(setup):
    cfg, tables, G = setup
    n1 = cfg.n_steps_s1
    st_a = engine_scan.antithetic_state(cfg, tables, G[:, :n1])
    zw = engine_linear.zbc_weights(cfg, tables)
    st_b = engine_linear.antithetic_state(cfg, zw, G[:, :n1])
    for fa, fb in zip(st_a, st_b):
        np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                                   rtol=2e-5, atol=2e-6)


def test_dual_state_agreement(setup):
    cfg, tables, G = setup
    n1 = cfg.n_steps_s1
    st_a = engine_scan.dual_state(cfg, tables, G[:, :n1])
    zw = engine_linear.zbc_weights(cfg, tables)
    st_b = engine_linear.dual_state(cfg, zw, G[:, :n1])
    for fa, fb in zip(st_a, st_b):
        np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                                   rtol=3e-5, atol=3e-6)


def test_curve_sums_agreement(setup):
    cfg, tables, G = setup
    s_a = engine_scan.curve_discount_sums(cfg, tables, G)
    cw = engine_linear.curve_weights(cfg, tables)
    s_b = engine_linear.curve_discount_sums(cfg, cw, G)
    np.testing.assert_allclose(np.asarray(s_a), np.asarray(s_b), rtol=3e-5)


def test_antithetic_legs_are_mirrored(setup):
    """+G and -G legs must be exact mirrors: running the scan on -G must
    swap the legs bitwise."""
    cfg, tables, G = setup
    st = engine_scan.antithetic_state(cfg, tables, G)
    st_neg = engine_scan.antithetic_state(cfg, tables, -G)
    np.testing.assert_array_equal(np.asarray(st.r_p), np.asarray(st_neg.r_m))
    np.testing.assert_array_equal(np.asarray(st.i_p), np.asarray(st_neg.i_m))


def test_zero_shock_path_is_deterministic_mean(setup):
    """G = 0 must give the deterministic drift path on both engines and a
    positive short rate near theta/a levels."""
    cfg, tables, _ = setup
    G0 = jnp.zeros((1, cfg.n_steps_s1), jnp.float32)
    st = engine_scan.antithetic_state(cfg, tables, G0)
    assert float(st.r_p[0]) == float(st.r_m[0])
    assert 0.0 < float(st.r_p[0]) < 0.1


@pytest.mark.parametrize("kw", [
    dict(a=0.3, sigma=0.02, t_final=5.0, n_steps=50, n_mat=11, s1=2.0, s2=5.0),
    dict(a=2.5, sigma=0.25, t_final=10.0, n_steps=200, n_mat=21, s1=5.0, s2=10.0),
    dict(a=0.05, sigma=0.01, t_final=20.0, n_steps=100, n_mat=11, s1=10.0,
         s2=20.0, r0=0.05),
])
def test_engine_agreement_across_configs(kw):
    """Weight derivations must hold across the parameter space, not just
    the reference configuration (fuzz over mean reversion, vol, horizon)."""
    cfg = tiny_config(n_paths=1 << 10, path_block=1 << 10, **kw)
    tables = hw.step_tables(cfg, cfg.sigma)
    G = jax.random.normal(jax.random.key(2), (128, cfg.n_steps), jnp.float32)
    n1 = cfg.n_steps_s1
    st_a = engine_scan.antithetic_state(cfg, tables, G[:, :n1])
    zw = engine_linear.zbc_weights(cfg, tables)
    st_b = engine_linear.antithetic_state(cfg, zw, G[:, :n1])
    for fa, fb in zip(st_a, st_b):
        np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                                   rtol=2e-4, atol=5e-6)
    s_a = engine_scan.curve_discount_sums(cfg, tables, G)
    cw = engine_linear.curve_weights(cfg, tables)
    s_b = engine_linear.curve_discount_sums(cfg, cw, G)
    np.testing.assert_allclose(np.asarray(s_a), np.asarray(s_b), rtol=2e-4)
    # exact engine covariance consistency: E[z z^T] == U^T U via Cholesky
    import numpy as onp
    from hullwhite_tpu.ops import engine_exact
    u, w = engine_linear._shock_shapes(cfg, n1)
    l11, l21, l22 = engine_exact.zbc_chol(cfg)
    C = onp.array([[l11**2, l11*l21], [l11*l21, l21**2 + l22**2]])
    u64, w64 = onp.asarray(u, onp.float64), onp.asarray(w, onp.float64)
    C_direct = onp.array([[u64@u64, u64@w64], [u64@w64, w64@w64]])
    onp.testing.assert_allclose(C, C_direct, rtol=1e-5)
