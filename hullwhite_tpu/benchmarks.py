"""Engine-tier benchmark harness.

The analogue of the reference's reduction-strategy benchmark
(src/benchmark_reductions.cu, C40): where the CUDA project compares three
reduction implementations of the same pricing kernel (naive atomics /
shared-memory tree / warp+block shuffle), this framework compares its
engine tiers of the same estimator:

    scan          sequential lax.scan over steps  (the "naive" tier)
    linear        full shock matmul
    exact         Cholesky functional sampling

with the same cross-variant price-consistency gate (the reference requires
< 1e-6 absolute agreement between its kernels, benchmark_reductions.cu:
158-169; our tiers consume different random streams, so the gate is
4-sigma statistical).  ``--sweep`` adds the path_block autotune sweep, the
analogue of the block-size sweep (3_sensitivity_analysis.cu:277-371, C39).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .config import HWConfig
from . import pricing
from .ops.payoffs import cv_estimate
from .utils import io as hwio
from .utils.timing import bench

# the scan tier is the step-by-step design antipattern the framework
# exists to avoid; benchmark it at reduced size
SCAN_PATHS = 1 << 16


def run_benchmark(cfg: HWConfig, key, reps: int = 10, sweep: bool = False):
    engines = ["linear", "exact"]
    market = pricing.bootstrap_curve(cfg, key, engine="exact")

    print("--- Engine-tier benchmark: ZBC control-variate pricing ---")
    print(f"config: {cfg.n_paths} path pairs x {cfg.n_steps_s1} steps to S1"
          f" (+ scan tier at {SCAN_PATHS} pairs)\n")
    print(f"{'engine':14s} {'time (ms)':>10s} {'M paths/s':>10s} "
          f"{'price':>12s} {'beta':>8s}")

    rows = {}
    for eng in engines:
        prep = pricing._option_prep_fn(cfg, eng, "zbc")(
            cfg.sigma, cfg.sigma, market)
        f = pricing._option_run_fn(cfg, eng, "zbc", None)
        dt, m = bench(f, key, prep, market, n=reps)
        est = cv_estimate(jnp.asarray(m), market.P[-1])
        rows[eng] = {"ms": dt * 1e3,
                     "paths_per_sec": 2 * cfg.n_paths / dt,
                     "price": float(est.price), "beta": float(est.beta)}
        print(f"{eng:14s} {dt*1e3:10.3f} {2*cfg.n_paths/dt/1e6:10.0f} "
              f"{float(est.price):12.8f} {float(est.beta):8.4f}", flush=True)

    # scan tier, reduced size (normalized throughput still comparable;
    # the tier exists as the semantic reference — the step-by-step
    # antipattern the framework avoids)
    scan_pairs = min(cfg.n_paths, SCAN_PATHS)
    scfg = cfg.replace(n_paths=scan_pairs,
                       path_block=min(cfg.path_block, SCAN_PATHS))
    prep = pricing._option_prep_fn(scfg, "scan", "zbc")(
        scfg.sigma, scfg.sigma, market)
    f = pricing._option_run_fn(scfg, "scan", "zbc", None)
    dt, m = bench(f, key, prep, market, n=3)
    est = cv_estimate(jnp.asarray(m), market.P[-1])
    rows["scan"] = {"ms": dt * 1e3,
                    "paths_per_sec": 2 * scfg.n_paths / dt,
                    "price": float(est.price), "beta": float(est.beta),
                    "n_paths": scan_pairs}
    print(f"{f'scan ({scan_pairs})':14s} {dt*1e3:10.3f} "
          f"{2*scfg.n_paths/dt/1e6:10.0f} "
          f"{float(est.price):12.8f} {float(est.beta):8.4f}", flush=True)

    best = max((e for e in rows if e != "scan"),
               key=lambda e: rows[e]["paths_per_sec"])

    base = min(rows, key=lambda e: rows[e]["paths_per_sec"])
    print(f"\nspeedup (best '{best}' vs slowest '{base}'): "
          f"{rows[best]['paths_per_sec']/rows[base]['paths_per_sec']:.1f}x")

    # price-consistency gate (statistical: independent streams); the scan
    # tier runs fewer paths, so its own MC noise sets its tolerance —
    # without this a full-scale run had a ~3% chance of a spurious FAIL
    prices = np.array([r["price"] for r in rows.values()
                       if "n_paths" not in r])
    se = 0.05 / np.sqrt(2 * cfg.n_paths)  # payoff sd ~0.05
    tol = max(8 * se, 3e-4)
    spread = float(np.ptp(prices))
    consistent = spread < tol
    if "scan" in rows:
        se_scan = 0.05 / np.sqrt(2 * scan_pairs)
        scan_dev = abs(rows["scan"]["price"] - float(np.mean(prices)))
        scan_ok = scan_dev < 6 * se_scan + tol
        consistent = consistent and scan_ok
        print(f"scan-tier deviation: {scan_dev:.2e} "
              f"(tol {6 * se_scan + tol:.2e}) -> "
              f"{'PASS' if scan_ok else 'FAIL'}")
    print(f"price consistency: max spread {spread:.2e} "
          f"(tol {tol:.2e}) -> {'PASS' if consistent else 'FAIL'}")

    result = {"engines": rows, "consistency_pass": bool(consistent),
              "price_spread": spread}

    if sweep:
        result["block_sweep"] = _block_sweep(cfg, key, market, "exact")

    hwio.write_json(hwio.DATA_DIR / "benchmark_engines.json",
                    "Engine benchmark", cfg, results=result)
    print("saved data/benchmark_engines.json")
    return 0 if consistent else 1


def ab_compare(cfg_a, cfg_b, key, market, engine_a, engine_b,
               n_runs: int = 20, label: str = ""):
    """N-run A/B of two (config, engine) arms at the 20-run CI level.

    The statistical-validation analogue of the reference's method-agreement
    z-test (3_sensitivity_analysis.cu:656-695), applied to engineering
    choices instead of estimators: engines or matmul precisions
    ('default' vs fp32 'highest').  Both
    arms run n_runs independent seeds in one device call each
    (pricing.validate_zbc_runs / validate_vega_runs); the z-score uses the
    measured per-arm standard errors.
    """
    import numpy as np

    out = {"label": label, "n_runs": n_runs,
           "a": f"{engine_a}/{cfg_a.matmul_precision}",
           "b": f"{engine_b}/{cfg_b.matmul_precision}"}
    for kind in ("price", "vega"):
        if kind == "price":
            xa = np.asarray([float(x) for x in pricing.validate_zbc_runs(
                cfg_a, key, market, n_runs=n_runs, engine=engine_a).price])
            xb = np.asarray([float(x) for x in pricing.validate_zbc_runs(
                cfg_b, key, market, n_runs=n_runs, engine=engine_b).price])
        else:
            xa = np.asarray([float(x) for x in pricing.validate_vega_runs(
                cfg_a, key, market, n_runs=n_runs, engine=engine_a)])
            xb = np.asarray([float(x) for x in pricing.validate_vega_runs(
                cfg_b, key, market, n_runs=n_runs, engine=engine_b)])
        # both arms run the SAME folded seeds, so the runs are PAIRED: use
        # the SE of the per-run differences.  For same-engine arms (e.g. a
        # precision A/B on identical normals) the pairing is near-perfect
        # and a deterministic shift shows up at its true (huge) z instead
        # of being washed out by sqrt(se_a^2 + se_b^2); for different
        # engines the streams are independent and the paired SE reduces to
        # the unpaired one.
        d = xa - xb
        diff = float(d.mean())
        se = float(d.std(ddof=1) / np.sqrt(n_runs))
        if se < 1e-15:
            z = 0.0 if abs(diff) < 1e-15 else float("inf") * np.sign(diff)
        else:
            z = diff / se
        out[kind] = {"mean_a": float(xa.mean()), "mean_b": float(xb.mean()),
                     "diff": diff, "se_diff": se, "z": z}
        print(f"[A/B {label}] {kind}: A={xa.mean():.8f} B={xb.mean():.8f} "
              f"diff={diff:+.2e} (paired SE {se:.2e}, z={z:+.2f})")
    return out


def _curve_ab(cfg_a, cfg_b, key, engine_a, engine_b, n_runs):
    """Paired P(0,10) A/B across n_runs bootstrap seeds (the curve is the
    one deliverable the option-kernel A/B doesn't cover)."""
    import numpy as np

    pa, pb = [], []
    for i in range(n_runs):
        ki = jax.random.fold_in(key, 3000 + i)
        pa.append(float(np.asarray(
            pricing.bootstrap_curve(cfg_a, ki, engine=engine_a).P)[-1]))
        pb.append(float(np.asarray(
            pricing.bootstrap_curve(cfg_b, ki, engine=engine_b).P)[-1]))
    d = np.asarray(pa) - np.asarray(pb)
    diff = float(d.mean())
    se = float(d.std(ddof=1) / np.sqrt(n_runs)) if n_runs > 1 else 0.0
    z = diff / se if se > 1e-15 else (
        0.0 if abs(diff) < 1e-15 else float("inf") * np.sign(diff))
    print(f"[A/B] P(0,10): A={np.mean(pa):.8f} B={np.mean(pb):.8f} "
          f"diff={diff:+.2e} (paired SE {se:.2e}, z={z:+.2f})")
    return {"mean_a": float(np.mean(pa)), "mean_b": float(np.mean(pb)),
            "diff": diff, "se_diff": se, "z": float(z)}


# (mode) -> (zbc/vega engines A/B, curve engines A/B, precision A/B)
AB_MODES = {
    # matmul input precision: fp32 ("highest") vs the platform default
    # ("default": TF32 on a GPU) on identical seeds — paired diffs
    # resolve deterministic shifts exactly
    "precision": dict(opt=("exact", "exact"), curve=("linear", "linear"),
                      prec=("highest", "default"),
                      label="matmul precision highest vs default"),
}


def run_ab(cfg: HWConfig, key, mode: str, n_runs: int = 20):
    """Repeatable paired A/B (``cli benchmark --ab precision`` ->
    data/ab_results_{mode}.json).

    The statistical-validation analogue of the reference's method-
    agreement z-test (3_sensitivity_analysis.cu:656-695) applied to
    engineering choices; see ab_compare for the paired-seed design."""
    spec = AB_MODES[mode]
    cfg_a = cfg_b = cfg
    if spec["prec"]:
        cfg_a = cfg.replace(matmul_precision=spec["prec"][0])
        cfg_b = cfg.replace(matmul_precision=spec["prec"][1])
    market = pricing.bootstrap_curve(cfg, key, engine="exact")
    out = ab_compare(cfg_a, cfg_b, key, market, *spec["opt"],
                     n_runs=n_runs, label=spec["label"])
    out["mode"] = mode
    if spec["curve"]:
        out["curve_P10"] = _curve_ab(cfg_a, cfg_b, key, *spec["curve"],
                                     n_runs)
    agree = all(abs(out[k]["z"]) < 3.0 for k in ("price", "vega"))
    print(f"A/B verdict ({mode}): "
          f"{'AGREE at the 3-sigma level' if agree else 'DISAGREE'}")
    # one file per mode
    hwio.write_json(hwio.DATA_DIR / f"ab_results_{mode}.json",
                    f"A/B {mode}", cfg, results=out)
    print(f"saved data/ab_results_{mode}.json")
    return 0


def _block_sweep(cfg, key, market, engine):
    """path_block autotune sweep (analogue of reference C39 block sizes)."""
    print(f"\n--- path_block sweep [{engine}] ---")
    out = {}
    for pb_log2 in [13, 14, 15, 16, 17]:
        pb = 1 << pb_log2
        if cfg.n_paths % pb != 0:
            continue
        c = cfg.replace(path_block=pb)
        try:
            prep = pricing._option_prep_fn(c, engine, "vega")(
                c.sigma, c.sigma, market)
            f = pricing._option_run_fn(c, engine, "vega", None)
            dt, _ = bench(f, key, prep, market, n=10)
        except ValueError as e:
            print(f"path_block=2^{pb_log2}: skipped ({e})")
            continue
        out[pb] = dt * 1e3
        print(f"path_block=2^{pb_log2}: {dt*1e3:8.3f} ms "
              f"({c.n_paths/dt/1e6:6.0f} M paths/s)")
    best = min(out, key=out.get)
    print(f"best: path_block={best} ({out[best]:.3f} ms)")
    return {str(k): v for k, v in out.items()}
