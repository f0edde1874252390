#!/usr/bin/env python
"""On-card smoke test of the Q1 -> Q2 -> Q3 pricing path.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: sharded == single only

Runs the public pricing entry points at the reference's full size
(``HWConfig()``: 2^20 antithetic pairs x 1000 steps x 101 maturities)
and checks every result against an independent reference: the float64
closed forms of ``models.oracles``, the reference's published numbers,
the same computation on the CPU backend, and the fp64 Bermudan DP
oracle.  Each phase prints one line of numbers beside their tolerances.
Any failed phase makes the exit code non-zero; only a run in which every
phase passed prints the final JSON line
``{"ok": true, "device": {"platform", "kind", "count"}}``.

It refuses to run (non-zero exit, no JSON line) when JAX sees no GPU.
One process drives the card(s).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

P10_PUBLISHED = 0.876844          # reference README, Q1
ZBC_CI = (0.0354, 0.0355)         # reference 20-run 95% CI, Q2b
BETA_PUBLISHED = 0.166
RHO_PUBLISHED = 0.673


# ---------------------------------------------------------------------------
# tolerance checks (pure functions: tested on the CPU)
# ---------------------------------------------------------------------------

class Gate:
    """Collects (name, value, reference, tolerance) checks for one phase."""

    def __init__(self, phase: str):
        self.phase = phase
        self.rows = []

    def close(self, name, value, ref, tol):
        """|value - ref| <= tol, with value finite."""
        value, ref = float(value), float(ref)
        ok = math.isfinite(value) and abs(value - ref) <= tol
        self.rows.append((name, value, ref, tol, ok))
        return ok

    def below(self, name, value, tol):
        """value <= tol (value a non-negative error), with value finite."""
        value = float(value)
        ok = math.isfinite(value) and value <= tol
        self.rows.append((name, value, 0.0, tol, ok))
        return ok

    def info(self, name, value):
        self.rows.append((name, float(value), None, None, True))

    @property
    def ok(self):
        return all(r[4] for r in self.rows)

    def line(self):
        parts = []
        for name, v, ref, tol, ok in self.rows:
            if tol is None:
                parts.append(f"{name}={v:.8g}")
            elif ref == 0.0:
                parts.append(f"{name}={v:.3e}<={tol:.1e}"
                             f"{'' if ok else ' FAIL'}")
            else:
                parts.append(f"{name}={v:.8g} ref={ref:.8g} "
                             f"tol={tol:.2e}{'' if ok else ' FAIL'}")
        status = "ok" if self.ok else "FAIL"
        return f"[{self.phase}] {status}: " + "; ".join(parts)


def curve_standard_errors(cfg, P_oracle):
    """Closed-form standard error of each antithetic-pair P(0,T_m).

    A pair contributes exp(-c) cosh(z) with z ~ N(0, s^2) (the exact
    engine's sampling law), so Var = exp(-2c) (E cosh^2 z - (E cosh z)^2)
    = exp(-2c) ((1 + e^{2 s^2}) / 2 - e^{s^2}), and exp(-c) = P e^{-s^2/2}.
    """
    import numpy as np

    from hullwhite_tpu.models import hull_white as hw
    from hullwhite_tpu.ops import engine_exact

    LT = engine_exact.curve_chol(cfg).astype(np.float64)
    s2 = (cfg.sigma * hw.sig_st_unit(cfg)) ** 2 * np.sum(LT ** 2, axis=0)
    s2 = np.concatenate([[0.0], s2])
    var = (1.0 + np.exp(2.0 * s2)) / 2.0 - np.exp(s2)
    P = np.asarray(P_oracle, np.float64)
    return P * np.exp(-s2 / 2.0) * np.sqrt(np.maximum(var, 0.0)
                                           / cfg.n_paths)


def max_ulp_error(values, reference):
    """Largest |value - reference| in float32 ulps of the reference."""
    import numpy as np

    ref = np.asarray(reference, np.float64)
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(np.asarray(values, np.float64) - ref) / ulp))


def last_line(devices) -> str:
    """The contract's final line for ``devices`` (jax.devices())."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def oracle_market(cfg):
    """MarketCurve from the float64 closed forms (input to phases whose
    reference must not carry the curve's own Monte Carlo noise)."""
    import jax.numpy as jnp
    import numpy as np

    from hullwhite_tpu.models import hull_white as hw
    from hullwhite_tpu.models import oracles

    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    f = oracles.forward_rate(cfg, Ts)
    return hw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                          f=jnp.asarray(f, jnp.float32)), P


def phase_device(cache_dir):
    import jax

    from hullwhite_tpu.backend import card_info

    g = Gate("device")
    d = jax.devices()[0]
    print(f"card: {card_info()}", flush=True)
    print(f"[device] platform={d.platform} kind={d.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__} "
          f"compile_cache={cache_dir}", flush=True)
    return g


def phase_curve(cfg, key):
    """Q1: default engine and the full-step linear engine vs the oracle."""
    import numpy as np

    from hullwhite_tpu import backend, pricing

    g = Gate("q1")
    _, P_or = oracle_market(cfg)
    se = curve_standard_errors(cfg, P_or)
    engine = backend.default_engine()
    markets = {}
    for eng in dict.fromkeys((engine, "linear")):
        t0 = time.perf_counter()
        m = pricing.bootstrap_curve(cfg, key, engine=eng)
        P = np.asarray(m.P, np.float64)
        g.info(f"{eng}_s", time.perf_counter() - t0)
        # 5 SE of this run, plus 2e-6 for fp32 accumulation of 2^21 legs
        dev = np.abs(P - P_or) / (5.0 * se + 2e-6)
        g.below(f"{eng}_max_dev_in_5se", float(dev.max()), 1.0)
        # the published P(0,10) is itself one 2^20-pair estimate: the
        # difference of two independent runs has sqrt(2) x this SE
        g.close(f"{eng}_P10_vs_published", P[-1], P10_PUBLISHED,
                5.0 * math.sqrt(2.0) * se[-1] + 2e-6)
        markets[eng] = m
    print(g.line(), flush=True)
    return g, markets[engine]


def phase_q2(cfg, key, market):
    """Q2a theta recovery; Q2b ZBC price at 2^20 and 2^24 pairs."""
    import jax

    from hullwhite_tpu import backend, pricing

    g = Gate("q2")
    rec = pricing.theta_recovery(cfg, market)
    g.below("theta_max_error", rec.max_error, 1e-2)
    engine = backend.default_engine()
    k2 = jax.random.fold_in(key, 54321)
    for log2 in (20, 24):
        c = cfg.replace(n_paths=1 << log2,
                        path_block=min(1 << log2, 1 << 19))
        est = pricing.price_zbc(c, k2, market, engine=engine)
        se = math.sqrt(float(est.var_x)
                       * (1.0 - float(est.correlation) ** 2)
                       / float(est.n))
        price = float(est.price)
        inside = ZBC_CI[0] <= price <= ZBC_CI[1]
        g.info(f"zbc_2e{log2}_in_published_ci", inside)
        # the published CI bounds a 20-run mean; one run adds its own
        # noise, so the interval is widened by 4 SE of this run
        mid, half = sum(ZBC_CI) / 2.0, (ZBC_CI[1] - ZBC_CI[0]) / 2.0
        g.close(f"zbc_2e{log2}", price, mid, half + 4.0 * se)
        g.close(f"beta_2e{log2}", est.beta, BETA_PUBLISHED, 0.01)
        g.close(f"rho_2e{log2}", est.correlation, RHO_PUBLISHED, 0.02)
    print(g.line(), flush=True)
    return g


def phase_q3(cfg, key, market):
    """Pathwise vega vs the closed form and FD with common random numbers."""
    import jax

    from hullwhite_tpu import backend, greeks, pricing
    from hullwhite_tpu.models import oracles

    g = Gate("q3")
    engine = backend.default_engine()
    k3 = jax.random.fold_in(key, 777)
    v = float(pricing.pathwise_vega(cfg, k3, market, engine=engine))
    i1 = int(round(cfg.s1 / cfg.mat_spacing))
    v_or = oracles.zbc_vega(cfg, float(market.P[i1]), float(market.P[-1]))
    fd = float(greeks.fd_vega_crn(cfg, k3, market, engine=engine).vega)
    g.close("pathwise_vs_oracle", v, v_or, 0.005 * abs(v_or))
    g.close("pathwise_vs_fd_crn", v, fd, 0.005 * abs(fd))
    print(g.line(), flush=True)
    return g


def path_values(cfg, engine, key, n_paths):
    """Per-path outputs of ``engine``'s block functions on ``n_paths``
    rows of normals drawn from ``key`` on the default device: every
    curve path's discount factors summed over its two antithetic legs
    (relative to their value), and
    the ZBC path state's shocks (r, I) - (c_r, c_I) (relative to their
    standard deviation over the paths)."""
    import jax
    import jax.numpy as jnp

    from hullwhite_tpu.models import hull_white as hw
    from hullwhite_tpu.ops import engine_exact, engine_linear

    eng = {"exact": engine_exact, "linear": engine_linear}[engine]
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, jnp.float32)
    cw, zw = eng.curve_weights(cfg, tables), eng.zbc_weights(cfg, tables)
    k_curve = cfg.n_mat - 1 if engine == "exact" else cfg.n_steps
    k_zbc = 2 if engine == "exact" else cfg.n_steps_s1
    kc, kz = jax.random.split(key)
    Gc = jax.random.normal(kc, (n_paths, k_curve), jnp.float32)
    Gz = jax.random.normal(kz, (n_paths, k_zbc), jnp.float32)

    @jax.jit
    def run(Gc, Gz):
        legs = jax.vmap(lambda g: eng.curve_discount_sums(
            cfg, cw, g[None, :]))(Gc)
        st = eng.antithetic_state(cfg, zw, Gz)
        z = jnp.stack([st.r_p - st.r_m, st.i_p - st.i_m], axis=1) / 2.0
        return legs, z

    return run(Gc, Gz)


def phase_gpu_vs_cpu(cfg, *, gpu_precision=None):
    """Same key (``cfg.seed``, made on each device) through exact and
    linear on the GPU and on the CPU device.

    Threefry gives the same bits on both backends; what may differ is the
    last ulp of erfinv/exp and the fp32 summation order.  Prices: P to
    2e-6 relative, the ZBC price to 1e-6 absolute.  A TF32 matmul (about
    3 decimal digits per operand) moves each path's shock by ~1e-3 of
    its SD, but the prices average that down to the order of their own
    gates; so the per-path rows (``path_values``, 2^14 paths) are what
    catch it: legs to 1e-5 relative, shocks to 3e-5 of their SD, each
    about a decade from both the fp32 and the TF32 reading on an H100.
    ``gpu_precision`` runs only the GPU side at another matmul precision:
    the control that shows the phase failing on TF32 (PERF.md)."""
    import jax
    import numpy as np

    from hullwhite_tpu import pricing

    g = Gate("gpu_vs_cpu")
    out = {}
    gpu_cfg = (cfg if gpu_precision is None
               else cfg.replace(matmul_precision=gpu_precision))
    for where, dev, c in (("gpu", jax.devices()[0], gpu_cfg),
                          ("cpu", jax.devices("cpu")[0], cfg)):
        with jax.default_device(dev):
            market, _ = oracle_market(c)
            k = jax.random.key(int(c.seed))
            for eng in ("exact", "linear"):
                P = np.asarray(pricing.bootstrap_curve(c, k, engine=eng).P,
                               np.float64)
                z = float(pricing.price_zbc(c, k, market, engine=eng).price)
                legs, zs = (np.asarray(a, np.float64)
                            for a in path_values(c, eng, k, 1 << 14))
                out[where, eng] = (P, z, legs, zs)
    for eng in ("exact", "linear"):
        Pg, zg, lg, sg = out["gpu", eng]
        Pc, zc, lc, sc = out["cpu", eng]
        g.below(f"{eng}_P_max_rel", float(np.max(np.abs(Pg - Pc) / Pc)), 2e-6)
        g.below(f"{eng}_zbc_abs", abs(zg - zc), 1e-6)
        g.below(f"{eng}_path_legs_max_rel",
                float(np.max(np.abs(lg - lc) / lc)), 1e-5)
        g.below(f"{eng}_path_state_max_rel",
                float(np.max(np.abs(sg - sc) / sc.std(axis=0))), 3e-5)
    print(g.line(), flush=True)
    return g


def bermudan_bracket(cfg, key, market, *, n_paths, n_blocks, rights=5,
                     mesh=None):
    """Annual-exercise Bermudan receiver on a 5y swap starting at 5y;
    ``rights=5`` is bench.py's bracket configuration."""
    from hullwhite_tpu import bermudan
    from hullwhite_tpu.instruments import swap_fixed_leg

    sched = swap_fixed_leg(cfg, 0.025, 5.0)
    ex = [5.0 + j for j in range(rights)]
    res = bermudan.price_bermudan(cfg, key, market, sched, ex,
                                  n_paths=n_paths, n_blocks=n_blocks,
                                  mesh=mesh)
    return res, sched, ex


def phase_bermudan(cfg, key):
    """Bracket vs its fp64 DP oracle; the card's exp accuracy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hullwhite_tpu import bermudan

    g = Gate("bermudan")
    market, _ = oracle_market(cfg)
    res, sched, ex = bermudan_bracket(cfg, key, market, n_paths=1 << 17,
                                      n_blocks=8)
    orc = bermudan.dp_oracle(cfg, market, sched, ex, n_grid=6001)
    lo, up = float(res.price_cv), float(res.upper)
    g.close("lower", lo, orc, BERMUDAN_TOL)
    g.close("upper", up, orc, BERMUDAN_TOL)
    # the bracket stays ordered up to its own standard errors
    g.below("lower_above_upper", max(0.0, lo - up),
            3.0 * (float(res.cv_std_error) + float(res.upper_std_error)))
    x = np.random.default_rng(1).uniform(-12.0, 6.0, 1 << 16)
    x = x.astype(np.float32)
    e = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    g.info("exp_max_ulp", max_ulp_error(e, np.exp(x.astype(np.float64))))
    print(g.line(), flush=True)
    return g


# lower and upper bracket vs the fp64 DP oracle at 2^17 x 8 paths.  The
# bracket's own standard errors are ~2.8e-7 (CPU run of this config:
# gaps -3.3e-7 / -1.5e-7), so the gate is the 1e-6 pin, not 3e-7.
BERMUDAN_TOL = 1e-6


def phase_mesh(cfg, key, mesh, *, berm_paths, berm_blocks, berm_rights=5):
    """Every core product sharded over ``mesh`` vs the single-device run:
    randomness keys on the global block index, so only the reduction
    order differs (1e-6; 2e-6 for the bracket, which sums more terms)."""
    import numpy as np

    from hullwhite_tpu import backend, grid, pricing

    g = Gate(f"mesh{mesh.devices.size}")
    eng = backend.default_engine()

    def cmp(name, a, b, tol=1e-6):
        d = float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))
        g.below(name, d, tol)

    m1 = pricing.bootstrap_curve(cfg, key, engine=eng)
    cmp("curve", pricing.bootstrap_curve(cfg, key, engine=eng,
                                         mesh=mesh).P, m1.P)
    cmp("zbc", pricing.price_zbc(cfg, key, m1, engine=eng, mesh=mesh).price,
        pricing.price_zbc(cfg, key, m1, engine=eng).price)
    cmp("vega", pricing.pathwise_vega(cfg, key, m1, engine=eng, mesh=mesh),
        pricing.pathwise_vega(cfg, key, m1, engine=eng))
    Ks = [cfg.strike * (1 + s) for s in (-0.03, -0.015, 0.0, 0.015, 0.03)]
    S2s = [6.0, 7.0, 8.0, 9.0, 10.0]
    cmp("grid", grid.price_zbc_grid(cfg, key, m1, Ks, S2s, engine=eng,
                                    mesh=mesh).price,
        grid.price_zbc_grid(cfg, key, m1, Ks, S2s, engine=eng).price)
    bkw = dict(n_paths=berm_paths, n_blocks=berm_blocks, rights=berm_rights)
    b8, _, _ = bermudan_bracket(cfg, key, m1, mesh=mesh, **bkw)
    b1, _, _ = bermudan_bracket(cfg, key, m1, **bkw)
    cmp("bermudan_lower", b8.price, b1.price, 2e-6)
    cmp("bermudan_upper", b8.upper, b1.upper, 2e-6)
    g.info("P10", np.asarray(m1.P)[-1])
    print(g.line(), flush=True)
    return g


# ---------------------------------------------------------------------------

def run(phases) -> bool:
    """Run every phase; a raising phase counts as failed (its traceback
    goes to stderr) and the others still run."""
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            passed = fn().ok
        except Exception:  # noqa: BLE001 - reported, and fails the run
            traceback.print_exc()
            print(f"[{name}] FAIL: raised", flush=True)
            passed = False
        print(f"[{name}] {time.perf_counter() - t0:.1f}s", flush=True)
        ok = ok and passed
    return ok


def build_phases(four_cards: bool, cfg, key, devices, cache_dir):
    """(name, fn) pairs: the mesh phase alone with ``four_cards``, else
    the one-card path Q1 -> Q2 -> Q3 -> GPU vs CPU -> Bermudan."""
    phases = [("device", lambda: phase_device(cache_dir))]
    if four_cards:
        from hullwhite_tpu.parallel import mesh as pmesh

        big = cfg.replace(n_paths=1 << 24)
        mesh = pmesh.path_mesh(devices[:4])
        # the bracket with two exercise rights: the sharding invariant is
        # the same at k=5, at a fraction of the LSMC compile time
        return phases + [("mesh", lambda: phase_mesh(
            big, key, mesh, berm_paths=1 << 17, berm_blocks=8,
            berm_rights=2))]
    state = {}

    def q1():
        gate, state["market"] = phase_curve(cfg, key)
        return gate

    return phases + [
        ("q1", q1),
        ("q2", lambda: phase_q2(cfg, key, state["market"])),
        ("q3", lambda: phase_q3(cfg, key, state["market"])),
        ("gpu_vs_cpu", lambda: phase_gpu_vs_cpu(
            cfg.replace(n_paths=1 << 16))),
        ("bermudan", lambda: phase_bermudan(
            cfg.replace(path_block=1 << 16), key)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded == single-device phase "
                         "on a 1-D mesh of 4 GPUs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < n_cards:
        print(f"chip_smoke needs {n_cards} GPU(s); JAX sees "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 3

    from hullwhite_tpu import HWConfig
    from hullwhite_tpu.backend import enable_compile_cache

    cache_dir = enable_compile_cache()
    cfg = HWConfig()
    key = jax.random.key(cfg.seed)
    if not run(build_phases(args.four_cards, cfg, key, devices, cache_dir)):
        return 1
    print(last_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
