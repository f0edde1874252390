"""Command-line entry points: q1 / q2 / q3 / benchmark / all.

Replaces the reference's four executables (src/1_bond_pricing.cu,
src/2_option_pricing.cu, src/3_sensitivity_analysis.cu,
src/benchmark_reductions.cu) with argparse subcommands.  Differences by
design (SURVEY §5 "config/flag system"): everything is a flag — no
interactive scanf gates — and validation loops run by default with
``--validate 0`` to disable.

    python -m hullwhite_tpu.cli q1 --engine exact
    python -m hullwhite_tpu.cli q2 --validate 20
    python -m hullwhite_tpu.cli q3
    python -m hullwhite_tpu.cli benchmark
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import jax
import jax.numpy as jnp

from .backend import default_engine, enable_compile_cache
from .config import HWConfig
from . import greeks, pricing
from .models import hull_white as hw
from .ops import engine_scan
from .ops.rng import block_normals
from .utils import io as hwio
from .utils import stats as hwstats
from .utils.timing import bench


def _cfg(args) -> HWConfig:
    kw = {}
    if args.paths:
        kw["n_paths"] = args.paths
        # largest power-of-two divisor of n_paths, capped at 2^15 — always a
        # valid block size, so any --paths value is accepted
        kw["path_block"] = min(args.paths & -args.paths, 1 << 15)
    if getattr(args, "precision", None):
        kw["matmul_precision"] = args.precision
    return HWConfig(**kw)


def _key(cfg, args):
    return jax.random.key(args.seed if args.seed is not None else cfg.seed)


# ---------------------------------------------------------------------------
# Q1 — bond pricing / curve bootstrap (reference 1_bond_pricing.cu)
# ---------------------------------------------------------------------------

def cmd_q1(args):
    cfg = _cfg(args)
    key = _key(cfg, args)
    engine = args.engine or default_engine()
    print(f"--- Q1: Zero-coupon bond curve bootstrap [{engine}] ---")
    print(f"paths: {cfg.n_paths} x2 antithetic, steps: {cfg.n_steps}, "
          f"maturities: {cfg.n_mat}")

    # tables/weights prepare once outside the timed loop (the reference's
    # compute_constants also runs before its cudaEvent window)
    prep = pricing._curve_prep_fn(cfg, engine)(cfg.sigma, cfg.sigma)
    f = pricing._curve_sums_run_fn(cfg, engine, None)
    dt, sums = bench(f, key, prep, n=args.reps)
    P = jnp.asarray(sums) / (2.0 * cfg.n_paths)
    market = hw.MarketCurve(P=P, f=hw.forward_from_p(cfg, P))

    ms = dt * 1e3
    paths_s = 2 * cfg.n_paths / dt
    print(f"simulation time: {ms:.2f} ms   throughput: {paths_s/1e6:.0f} M paths/sec")
    Pn, fn = np.asarray(market.P), np.asarray(market.f)
    print(f"P(0,0)  = {Pn[0]:.6f}   (expect 1.0)")
    print(f"P(0,10) = {Pn[-1]:.6f}   (reference: 0.876844)")
    print(f"f(0,0)  = {fn[0]*100:.2f}%   (expect ~1.21%)")

    ok = (0.99 < Pn[0] < 1.01) and (0.3 < Pn[-1] < 0.9) and (0.005 < fn[0] < 0.02)
    print("validation:", "PASS" if ok else "FAIL")

    hwio.save_market(cfg, market)
    hwio.csv_timeseries(hwio.DATA_DIR / "P.csv", "P", Pn, cfg.mat_spacing)
    hwio.csv_timeseries(hwio.DATA_DIR / "f.csv", "f", fn, cfg.mat_spacing)
    hwio.write_json(
        hwio.DATA_DIR / "q1_results.json", "Q1: Bond Pricing", cfg,
        results={"P_0_0": float(Pn[0]), "P_0_10": float(Pn[-1]),
                 "f_0_0": float(fn[0]), "validation_pass": bool(ok),
                 "engine": engine},
        performance=hwio.performance_block(ms, 2 * cfg.n_paths),
        arrays={"P": Pn, "f": fn},
    )

    # 32 sample r(t) trajectories for plotting (reference simulate_paths_show)
    tables = hw.step_tables(cfg, cfg.sigma)
    G = block_normals(jax.random.fold_in(key, 999), 0, (32, cfg.n_steps))
    paths = np.asarray(engine_scan.sample_paths(cfg, tables, G))
    hwio.save_bin(hwio.DATA_DIR / "r_paths.bin", paths.astype(np.float32))

    hwio.summary_init(cfg)
    hwio.summary_append("Q1: BOND PRICING", [
        f"P(0,10) = {Pn[-1]:.6f}",
        f"f(0,0)  = {fn[0]*100:.2f}%",
        f"Simulation: {ms:.2f} ms ({paths_s/1e6:.0f} M paths/sec)",
        f"Validation: {'PASS' if ok else 'FAIL'}",
    ])
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# Q2 — theta recovery + ZBC option pricing (reference 2_option_pricing.cu)
# ---------------------------------------------------------------------------

def cmd_q2(args):
    cfg = _cfg(args)
    key = jax.random.fold_in(_key(cfg, args), 54321)
    engine = args.engine or default_engine()
    market = hwio.load_market(cfg)
    print(f"--- Q2: Theta recovery & ZBC option pricing [{engine}] ---")

    # Q2a
    rec = pricing.theta_recovery(cfg, market)
    print("\n[Q2a] theta(T) recovery from f(0,T):")
    stride = max(cfg.n_mat // 10, 1)
    print("   T     theta_true   theta_recovered   |error|")
    for i in range(0, cfg.n_mat, stride):
        print(f"  {float(rec.Ts[i]):4.1f}   {float(rec.theta_true[i]):.6f}"
              f"     {float(rec.theta_recovered[i]):.6f}        "
              f"{abs(float(rec.theta_recovered[i]-rec.theta_true[i])):.2e}")
    print(f"max error:  {rec.max_error:.2e}   mean error: {rec.mean_error:.2e}")
    print(f"recovery: {'SUCCESS' if rec.success else 'FAILED'} (threshold 0.01)")
    hwio.csv_comparison(hwio.DATA_DIR / "theta_comparison.csv",
                        np.asarray(rec.Ts), np.asarray(rec.theta_true),
                        np.asarray(rec.theta_recovered),
                        ["T", "theta_original", "theta_recovered"])
    hwio.write_json(hwio.DATA_DIR / "q2a_results.json", "q2a_results", cfg,
                    results={"max_error": rec.max_error,
                             "mean_error": rec.mean_error,
                             "success": bool(rec.success)})

    # Q2b
    prep = pricing._option_prep_fn(cfg, engine, "zbc")(cfg.sigma, cfg.sigma,
                                                       market)
    f = pricing._option_run_fn(cfg, engine, "zbc", None)
    dt, m = bench(f, key, prep, market, n=args.reps)
    from .ops.payoffs import cv_estimate

    est = cv_estimate(jnp.asarray(m), market.P[-1])
    ms = dt * 1e3
    print(f"\n[Q2b] ZBC(S1={cfg.s1}, S2={cfg.s2}, K=e^-0.1) with optimal-beta CV:")
    print(f"ZBC raw:                 {float(est.price_raw):.8f}")
    print(f"control mean:            {float(est.mean_control):.8f} "
          f"(expected P(0,S2) = {float(market.P[-1]):.8f})")
    print(f"beta* = Cov/Var:         {float(est.beta):.6f}")
    print(f"correlation:             {float(est.correlation):.6f}")
    print(f"expected var reduction:  {float(est.correlation)**2*100:.1f}% (rho^2)")
    print(f"ZBC (CV adjusted):       {float(est.price):.8f}   (reference: 0.03549203)")
    print(f"simulation time: {ms:.2f} ms   "
          f"throughput: {2*cfg.n_paths/dt/1e6:.0f} M paths/sec")
    hwio.write_json(
        hwio.DATA_DIR / "q2b_results.json", "q2b_results", cfg,
        results={"ZBC_control_variate": float(est.price),
                 "ZBC_raw": float(est.price_raw),
                 "beta_optimal": float(est.beta),
                 "correlation": float(est.correlation),
                 "engine": engine},
        performance=hwio.performance_block(ms, 2 * cfg.n_paths),
    )

    lines = [f"Theta recovery: {'SUCCESS' if rec.success else 'FAILED'} "
             f"(max error {rec.max_error:.2e})",
             f"ZBC option (CV): {float(est.price):.8f}",
             f"beta* = {float(est.beta):.6f}, rho = {float(est.correlation):.4f}"]

    if args.qmc:
        from .ops.qmc import price_zbc_qmc

        res = price_zbc_qmc(cfg, key, market, n_points=args.qmc)
        print(f"\n[Q2b] RQMC (scrambled Sobol, {res.n_points} pts x "
              f"{res.n_shifts} shifts):")
        print(f"price = {float(res.value):.8f} +/- {float(res.std_error):.2e} (SE)")
        # per-leg iid SE; antithetic pairing improves plain MC by a
        # further ~1.45x (measured), which this comparison does not credit
        mc_se = float(jnp.sqrt(est.var_x / est.n))
        print(f"SE vs per-leg-iid MC at 2^{cfg.n_paths.bit_length()-1} pairs: "
              f"{float(res.std_error):.2e} vs {mc_se:.2e} "
              f"({mc_se/max(float(res.std_error),1e-12):.0f}x tighter; "
              f"~{mc_se/1.45/max(float(res.std_error),1e-12):.0f}x vs antithetic MC)")
        lines.append(f"RQMC price: {float(res.value):.8f} "
                     f"+/- {float(res.std_error):.2e}")

    if args.validate:
        lines += _validate_zbc(cfg, key, market, engine, args.validate)
    hwio.summary_append("Q2: THETA RECOVERY & OPTION PRICING", lines)
    return 0 if rec.success else 1


def _validate_zbc(cfg, key, market, engine, n_runs):
    """20-run statistical validation (reference 2_option_pricing.cu:210-468).

    All n runs execute in ONE device call (lax.map over folded keys)
    instead of the reference's host loop re-launching the kernel per
    seed: one compile and one transfer for the whole validation."""
    print(f"\n[Q2b] statistical validation: {n_runs} independent runs "
          "(single device call)...")
    est = pricing.validate_zbc_runs(cfg, key, market, n_runs=n_runs,
                                    engine=engine, offset=1000)
    adj = [float(x) for x in est.price]
    raw = [float(x) for x in est.price_raw]
    betas = [float(x) for x in est.beta]
    corrs = [float(x) for x in est.correlation]

    s = hwstats.summarize(adj)
    s_raw = hwstats.summarize(raw)
    s_beta = hwstats.summarize(betas)
    vr = hwstats.variance_reduction_percent(adj, raw)
    print(f"mean price (CV):   {s.mean:.8f}  +/- {s.margin_of_error:.8f} (95% CI)")
    print(f"95% CI:            [{s.ci_lower:.8f}, {s.ci_upper:.8f}]")
    print(f"CV%:               {s.cv_percent:.4f}%")
    print(f"mean price (raw):  {s_raw.mean:.8f}  (sd {s_raw.std:.8f})")
    print(f"variance reduction: {vr:.1f}%")
    print(f"mean beta:         {s_beta.mean:.6f} (sd {s_beta.std:.6f})")
    print(f"mean correlation:  {np.mean(corrs):.4f}")
    if s_beta.std / abs(s_beta.mean) > 0.2:
        print(f"warning: beta varies significantly "
              f"(CV = {100*s_beta.std/abs(s_beta.mean):.1f}%)")
    hwio.csv_rows(hwio.DATA_DIR / "zbc_bootstrap_optimal.csv",
                  ["run", "price_adjusted", "price_raw", "beta_optimal",
                   "correlation"],
                  [(i + 1, adj[i], raw[i], betas[i], corrs[i])
                   for i in range(n_runs)])
    hwio.write_json(
        hwio.DATA_DIR / "zbc_statistics_optimal.json", "q2b_validation",
        cfg, results={
            "n_runs": n_runs, "mean_price": s.mean, "std_dev": s.std,
            "std_error": s.std_error, "ci_95": [s.ci_lower, s.ci_upper],
            "cv_percent": s.cv_percent,
            "variance_reduction_percent": vr,
            "mean_beta": s_beta.mean, "beta_std": s_beta.std,
            "mean_correlation": float(np.mean(corrs)),
            "quartiles": s.quartiles,
        })
    return [f"20-run mean (CV): {s.mean:.8f} +/- {s.margin_of_error:.8f}",
            f"Variance reduction: {vr:.1f}%"]


# ---------------------------------------------------------------------------
# Q3 — sensitivity analysis (reference 3_sensitivity_analysis.cu)
# ---------------------------------------------------------------------------

def cmd_q3(args):
    cfg = _cfg(args)
    key = jax.random.fold_in(_key(cfg, args), 777)
    engine = args.engine or default_engine()
    market = hwio.load_market(cfg)
    print(f"--- Q3: Sensitivity analysis (vega) [{engine}] ---")

    prep_v = pricing._option_prep_fn(cfg, engine, "vega")(
        cfg.sigma, cfg.sigma, market)
    fv = pricing._option_run_fn(cfg, engine, "vega", None)
    if args.profile:
        # pre-flight compile report (the reference prints its CUDA occupancy
        # analysis before launching the sensitivity kernel).  Opt-in: the
        # AOT lower/compile cannot share the jit cache, so this costs one
        # extra compile.
        try:
            from .utils.profile import format_report, kernel_report

            rep = kernel_report(fv, key, prep_v, market,
                                matmul_precision=cfg.matmul_precision)
            print("\n" + format_report(rep))
        except Exception as e:  # noqa: BLE001 - introspection is best-effort
            print(f"\n(kernel analysis unavailable: {e})")
    if getattr(args, "trace", None):
        # runtime trace capture: a perfetto/tensorboard trace of the hot
        # launches lands next to the XLA report (open with perfetto.dev
        # or tensorboard --logdir).  The reference's profiling story ends
        # at the static occupancy print; this is the dynamic half.
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(fv(key, prep_v, market))
        print(f"\n[trace] profiler trace written to {args.trace}/")
    dt, v = bench(fv, key, prep_v, market, n=args.reps)
    vega_pw = float(v[0] / v[1])
    ms = dt * 1e3
    print("\n[pathwise derivative] simultaneous r(t), dr/dsigma(t):")
    print(f"vega: {vega_pw:.6f}   (reference: 0.229895)")
    print(f"computation: {ms:.2f} ms   throughput: {cfg.n_paths/dt/1e6:.0f} M paths/sec")

    fd = greeks.fd_vega_crn(cfg, key, market, eps=args.eps, engine=engine)
    print(f"\n[finite difference, CRN] eps = {args.eps}:")
    print(f"ZBC(sigma-eps) = {float(fd.price_minus):.8f}")
    print(f"ZBC(sigma+eps) = {float(fd.price_plus):.8f}")
    print(f"FD vega = {float(fd.vega):.6f}   (reference: 0.230316)")

    fdr = greeks.fd_vega_recalibrated(cfg, key, jax.random.fold_in(key, 5),
                                      eps=args.eps, engine=engine)
    print(f"\n[finite difference, full market recalibration]:")
    print(f"FD vega (recalibrated) = {float(fdr.vega):.6f}")
    print("note: recalibration injects curve-level MC noise "
          "(the reference measures 127% error, README.md:51)")

    _, vega_ad = greeks.jvp_vega(cfg, key, market)
    print(f"\n[AD jvp through the simulation]: vega = {float(vega_ad):.6f}")

    rel = abs(vega_pw - float(fd.vega)) / abs(vega_pw) * 100
    print(f"\npathwise vs FD-CRN: {rel:.2f}% difference "
          f"({'<10% PASS' if rel < 10 else 'CHECK'})")
    sign_ok = vega_pw > 0 and float(fd.vega) > 0
    mag_ok = 0.05 < vega_pw < 0.5
    print(f"sign check: {'PASS' if sign_ok else 'FAIL'}   "
          f"magnitude check: {'PASS' if mag_ok else 'FAIL'}")

    results = {"sensitivity_mc": vega_pw, "sensitivity_fd": float(fd.vega),
               "sensitivity_fd_recalibrated": float(fdr.vega),
               "sensitivity_ad_jvp": float(vega_ad),
               "abs_diff": abs(vega_pw - float(fd.vega)), "engine": engine}

    if args.qmc:
        from .ops.qmc import vega_zbc_qmc

        res = vega_zbc_qmc(cfg, key, market, n_points=args.qmc)
        print(f"\n[RQMC vega] {res.n_points} pts x {res.n_shifts} shifts: "
              f"{float(res.value):.6f} +/- {float(res.std_error):.2e} (SE)")
        results["sensitivity_qmc"] = float(res.value)
        results["sensitivity_qmc_se"] = float(res.std_error)
    lines = [f"Sens (MC): {vega_pw:.6f}", f"Sens (FD): {float(fd.vega):.6f}",
             f"Sens (FD recal): {float(fdr.vega):.6f}"]

    if args.validate:
        print(f"\nstatistical validation: {args.validate} independent runs "
              "(single device call)...")
        samples = [float(x) for x in pricing.validate_vega_runs(
            cfg, key, market, n_runs=args.validate, engine=engine,
            offset=2000)]
        s = hwstats.summarize(samples)
        print(f"mean vega: {s.mean:.6f}   sd: {s.std:.6f}   SE: {s.std_error:.6f}")
        print(f"95% CI: [{s.ci_lower:.6f}, {s.ci_upper:.6f}]   CV: {s.cv_percent:.4f}%")
        agree = hwstats.method_agreement(vega_pw, float(fd.vega), s.std_error)
        print(f"z-score pathwise vs FD: {agree.z_score:.2f} -> "
              f"{agree.interpretation}")
        hwio.csv_rows(hwio.DATA_DIR / "vega_bootstrap.csv", ["run", "vega"],
                      [(i + 1, x) for i, x in enumerate(samples)])
        results.update({"validation_mean": s.mean, "validation_se": s.std_error,
                        "validation_ci": [s.ci_lower, s.ci_upper],
                        "z_score_vs_fd": agree.z_score})
        lines.append(f"20-run vega: {s.mean:.6f} +/- {s.margin_of_error:.6f}")

    hwio.write_json(hwio.DATA_DIR / "q3_results.json",
                    "Q3: Sensitivity Analysis", cfg, results=results,
                    performance=hwio.performance_block(ms, cfg.n_paths))
    hwio.summary_append("Q3: SENSITIVITY ANALYSIS", lines)
    return 0


# ---------------------------------------------------------------------------
# swaption / grid — instrument-family extensions (beyond the reference)
# ---------------------------------------------------------------------------


def cmd_benchmark(args):
    from .benchmarks import run_ab, run_benchmark

    if args.ab:
        return run_ab(_cfg(args), _key(_cfg(args), args), args.ab,
                      n_runs=args.ab_runs)
    return run_benchmark(_cfg(args), _key(_cfg(args), args),
                         reps=args.reps, sweep=args.sweep)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hullwhite_tpu",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--paths", type=int, default=None,
                        help="antithetic path pairs (default 2^20)")
    common.add_argument("--engine", choices=pricing.ENGINES, default=None)
    common.add_argument("--seed", type=int, default=None)
    common.add_argument("--reps", type=int, default=10,
                        help="timing repetitions")
    common.add_argument("--precision", default=None,
                        choices=["default", "high", "highest"],
                        help="matmul precision override (see "
                             "HWConfig.matmul_precision)")
    sub.add_parser("q1", parents=[common])
    p2 = sub.add_parser("q2", parents=[common])
    p2.add_argument("--validate", type=int, default=0, metavar="N",
                    help="run N-run statistical validation")
    p2.add_argument("--qmc", type=int, default=0, metavar="NPTS",
                    help="also price with randomized QMC on NPTS points")
    p3 = sub.add_parser("q3", parents=[common])
    p3.add_argument("--validate", type=int, default=0, metavar="N")
    p3.add_argument("--eps", type=float, default=1e-3)
    p3.add_argument("--qmc", type=int, default=0, metavar="NPTS")
    p3.add_argument("--profile", action="store_true",
                    help="print the XLA compile report before the hot launch")
    p3.add_argument("--trace", metavar="DIR", default=None,
                    help="capture a jax.profiler trace of one hot vega "
                         "launch into DIR (view with perfetto/tensorboard)")
    pb = sub.add_parser("benchmark", parents=[common])
    pb.add_argument("--sweep", action="store_true",
                    help="also sweep path_block sizes (reference C39)")
    pb.add_argument("--ab", choices=["precision"], default=None,
                    help="20-run paired A/B of the matmul precision "
                         "-> data/ab_results_{mode}.json")
    pb.add_argument("--ab-runs", type=int, default=20)
    ps = sub.add_parser("swaption", parents=[common])
    ps.add_argument("--rate", type=float, default=0.025)
    ps.add_argument("--tenor", type=float, default=5.0)
    ps.add_argument("--freq", type=float, default=1.0)
    ps.add_argument("--payer", action="store_true")
    ps.add_argument("--bermudan", action="store_true",
                    help="also price the Bermudan with annual exercises")
    ps.add_argument("--delta", action="store_true",
                    help="with --bermudan: CRN curve-delta of the "
                         "bracket vs the DP oracle")
    ps.add_argument("--bermudan-sweep", action="store_true",
                    help="bracket + DP oracle for k = 1..5 exercise "
                         "rights -> data/bermudan_sweep.json")
    sub.add_parser("grid", parents=[common])
    psw = sub.add_parser("sweep", parents=[common])
    psw.add_argument("--mesh", type=int, default=None, metavar="N",
                     help="device-mesh size (default: all devices; on "
                          "the CPU platform a virtual mesh of N devices "
                          "is provisioned, elsewhere too few is an error)")
    pg2 = sub.add_parser("g2pp", parents=[common])
    pg2.add_argument("--g2a", type=float, default=1.0)
    pg2.add_argument("--g2b", type=float, default=0.1)
    pg2.add_argument("--g2sigma", type=float, default=0.08)
    pg2.add_argument("--g2eta", type=float, default=0.02)
    pg2.add_argument("--g2rho", type=float, default=-0.6)
    pg2.add_argument("--rate", type=float, default=0.025)
    pg2.add_argument("--tenor", type=float, default=5.0)
    pg2.add_argument("--freq", type=float, default=1.0)
    pg2.add_argument("--eps", type=float, default=1e-2)
    pg2.add_argument("--validate", type=int, default=0, metavar="N")
    pc = sub.add_parser("cap", parents=[common])
    pc.add_argument("--rate", type=float, default=0.02)
    pc.add_argument("--tenor", type=float, default=4.0)
    pc.add_argument("--freq", type=float, default=1.0)
    pc.add_argument("--floor", action="store_true")
    prf = sub.add_parser("rfr", parents=[common])
    prf.add_argument("--strike", type=float, default=0.02)
    prf.add_argument("--start", type=float, default=None)
    prf.add_argument("--end", type=float, default=None)
    prf.add_argument("--tenor", type=float, default=3.0,
                     help="strip tenor in years (ignored when --end set)")
    prf.add_argument("--freq", type=float, default=1.0)
    prf.add_argument("--rqmc", action="store_true",
                     help="digitally-shifted Sobol draws")
    prf.add_argument("--averaged", action="store_true",
                     help="arithmetic-average style (default: compounded)")
    prf.add_argument("--n-obs", type=int, default=None,
                     help="averaged-style observation count "
                          "(default: one per step)")
    prf.add_argument("--g2", action="store_true",
                     help="also price the G2++ twins vs their oracles")
    for flag, dv in (("--g2a", 1.0), ("--g2b", 0.1), ("--g2sigma", 0.08),
                     ("--g2eta", 0.02), ("--g2rho", -0.6)):
        prf.add_argument(flag, type=float, default=dv)
    pcm = sub.add_parser("cms", parents=[common])
    pcm.add_argument("--rate", type=float, default=0.02)
    pcm.add_argument("--tenor", type=float, default=4.0)
    pcm.add_argument("--freq", type=float, default=1.0)
    pcm.add_argument("--swap-tenor", type=float, default=5.0)
    pcm.add_argument("--floor", action="store_true")
    pcm.add_argument("--g2", action="store_true",
                     help="also price the G2++ twin vs its oracle")
    pex = sub.add_parser("exotics", parents=[common])
    pex.add_argument("--strike", type=float, default=0.002,
                     help="CMS spread strike")
    pex.add_argument("--tenor", type=float, default=3.0)
    pex.add_argument("--freq", type=float, default=1.0)
    pex.add_argument("--long-tenor", type=float, default=4.0)
    pex.add_argument("--short-tenor", type=float, default=1.0)
    pex.add_argument("--coupon", type=float, default=0.03,
                     help="range-accrual coupon")
    pex.add_argument("--lo", type=float, default=0.010)
    pex.add_argument("--hi", type=float, default=0.022)
    pex.add_argument("--obs", type=int, default=5,
                     help="range observations per period")
    pex.add_argument("--target", type=float, default=0.055,
                     help="TARN cumulative-coupon knockout target")
    pex.add_argument("--cap-rate", type=float, default=0.013,
                     help="chooser/auto cap strike rate")
    pex.add_argument("--rights", type=int, default=2,
                     help="chooser cap exercise budget k")
    pex.add_argument("--ratchet-spread", type=float, default=0.0,
                     help="ratchet cap reset spread over the previous "
                          "fixing")
    pex.add_argument("--ko-barrier", type=float, default=0.05,
                     help="up-and-out cap knock-out LIBOR level")
    pex.add_argument("--fine", action="store_true",
                     help="fine G2 DP oracle grids (241, 91, 20) — "
                          "pure cross-check since the round-4 cubic "
                          "surfaces (defaults agree to ~4e-6)")
    pxv = sub.add_parser("xva", parents=[common])
    pxv.add_argument("--rate", type=float, default=0.02)
    pxv.add_argument("--tenor", type=float, default=4.0)
    pxv.add_argument("--freq", type=float, default=1.0)
    pxv.add_argument("--payer", action="store_true",
                     help="payer swap (default receiver)")
    pxv.add_argument("--quantile", type=float, default=0.95,
                     help="PFE quantile")
    pxv.add_argument("--hazard", type=float, default=0.02,
                     help="flat default intensity")
    pxv.add_argument("--recovery", type=float, default=0.4)
    pxv.add_argument("--n-blocks", type=int, default=4, dest="n_blocks")
    pxv.add_argument("--rqmc", action="store_true",
                     help="digitally-shifted Sobol blocks")
    pxv.add_argument("--g2", action="store_true",
                     help="also run the G2++ twin vs its oracle")
    pxv.add_argument("--netting", action="store_true",
                     help="also run a 3-swap netting set vs its "
                          "segment-decomposed oracle")
    pxv.add_argument("--csa", action="store_true",
                     help="also run the collateralized (threshold CSA, "
                          "lagged MPoR) profile vs its oracle")
    pxv.add_argument("--threshold", type=float, default=0.005,
                     help="CSA threshold H (posts (V-H)^+)")
    pxv.add_argument("--lag", type=int, default=1,
                     help="margin period of risk in reset periods "
                          "(0 = continuous margining)")
    pxv.add_argument("--bilateral", action="store_true",
                     help="also quote BCVA = CVA - DVA and asymmetric "
                          "FVA vs the bilateral oracle")
    pxv.add_argument("--wwr", action="store_true",
                     help="also quote the wrong-way-risk CVA under "
                          "lambda_t = hazard + gamma r_t vs its "
                          "two-tilt closed-form oracle")
    pxv.add_argument("--gamma", type=float, default=0.5,
                     help="intensity-rate slope (wrong-way for a payer, "
                          "right-way for a receiver)")
    pxv.add_argument("--mva", action="store_true",
                     help="also quote the MVA of delta-normal dynamic "
                          "initial margin vs its closed-form oracle")
    pxv.add_argument("--cds", metavar="QUOTES", default=None,
                     help="bootstrap a piecewise-constant hazard curve "
                          "from par CDS quotes 'mat:spread,...' (e.g. "
                          "'1:0.006,3:0.009,5:0.013') and price the "
                          "netted CVA under the term structure")
    pxv.add_argument("--bermudan", action="store_true",
                     help="also quote the Bermudan-swaption exposure "
                          "profile + CVA (American-MC XVA) vs the "
                          "forward-DP oracle")
    pxv.add_argument("--kva", action="store_true",
                     help="also quote the KVA (capital cost of the "
                          "netted 3-swap book, K = kappa EE) vs its "
                          "closed-form oracle")
    pxv.add_argument("--cost-capital", type=float, default=0.10,
                     help="capital hurdle rate c_h")
    pxv.add_argument("--capital-ratio", type=float, default=0.08,
                     help="capital per unit exposure kappa "
                          "(capital ratio x risk weight)")
    pxv.add_argument("--mpor", type=float, default=0.1,
                     help="margin period of risk in years (snapped to "
                          "the step grid)")
    pxv.add_argument("--spread-im", type=float, default=0.005,
                     help="IM funding spread")
    pxv.add_argument("--quantile-im", type=float, default=0.99,
                     help="IM quantile (z_q scale)")
    pxv.add_argument("--hazard-own", type=float, default=0.01,
                     help="own default intensity (DVA leg)")
    pxv.add_argument("--recovery-own", type=float, default=0.4)
    pxv.add_argument("--spread-borrow", type=float, default=0.005,
                     help="funding borrow spread (FCA)")
    pxv.add_argument("--spread-lend", type=float, default=0.002,
                     help="funding lend spread (FBA)")
    pnt = sub.add_parser("notes", parents=[common])
    pnt.add_argument("--sb-initial", type=float, default=0.02,
                     help="snowball initial coupon c_0")
    pnt.add_argument("--sb-spread", type=float, default=0.013)
    pnt.add_argument("--sb-cap", type=float, default=0.06)
    pnt.add_argument("--fl-cap", type=float, default=0.016,
                     help="capped-floater coupon cap")
    pnt.add_argument("--fl-spread", type=float, default=0.004)
    pnt.add_argument("--fl-tenor", type=float, default=3.0)
    pnt.add_argument("--floor", type=float, default=0.0)
    pnt.add_argument("--tenor", type=float, default=4.0)
    pnt.add_argument("--freq", type=float, default=1.0)
    pnt.add_argument("--fine", action="store_true",
                     help="fine G2 DP oracle grids (241, 91, 20)")
    pcal = sub.add_parser("calibrate", parents=[common])
    for flag, dv in [("--g2a", 1.0), ("--g2b", 0.1), ("--g2sigma", 0.08),
                     ("--g2eta", 0.02), ("--g2rho", -0.6)]:
        pcal.add_argument(flag, type=float, default=dv)
    # calibrate -> reprice book -> XVA on the calibrated parameters,
    # one composed artifact (round-5; the reference hard-codes its
    # parameters, common.cuh:31-39)
    sub.add_parser("pipeline", parents=[common])
    pall = sub.add_parser("all", parents=[common])
    pall.add_argument("--validate", type=int, default=0)
    pall.add_argument("--eps", type=float, default=1e-3)
    pall.add_argument("--qmc", type=int, default=0)
    pall.add_argument("--profile", action="store_true")

    args = ap.parse_args(argv)
    enable_compile_cache()
    if args.cmd == "q1":
        return cmd_q1(args)
    if args.cmd == "q2":
        return cmd_q2(args)
    if args.cmd == "q3":
        return cmd_q3(args)
    if args.cmd == "benchmark":
        return cmd_benchmark(args)
    if args.cmd in ("swaption", "grid", "sweep", "g2pp", "cap", "cms",
                    "rfr", "exotics", "notes", "calibrate", "pipeline"):
        # product drivers live in cli_products (one-driver-per-file,
        # imported lazily so `q1`-only runs skip the product imports)
        from . import cli_products

        return getattr(cli_products, f"cmd_{args.cmd}")(args)
    if args.cmd == "xva":
        from .cli_xva import cmd_xva

        return cmd_xva(args)
    if args.cmd == "all":
        rc = cmd_q1(args)
        rc |= cmd_q2(args)
        rc |= cmd_q3(args)
        args.sweep = False
        rc |= cmd_benchmark(args)
        return rc
    return 2


if __name__ == "__main__":
    sys.exit(main())
