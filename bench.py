#!/usr/bin/env python
"""Benchmark entry point — prints the headline metric as ONE JSON line.

Headline: Q1 curve-bootstrap throughput (antithetic paths/sec at the
reference configuration, 2^20 path pairs x 1000 steps x 101 maturities) on
the GPU's default engine, vs the reference's published 391 M paths/s
on a Tesla V100 (README.md:12, BASELINE.md).

Extra fields carry the engine/product matrix (Q2b ZBC pricing and Q3
pathwise vega at 2^24 paths, the full-step ``linear`` tier that applies
every SDE step's shock like the CUDA reference does, RQMC, G2++ ZBC and
the Bermudan bracket) and the accuracy readings (P(0,10), ZBC price,
beta*, vega against the published values).

The full JSON line is re-printed after every section, so a run cut short
still leaves its last complete record as the last line; optional
sections are skipped once the elapsed-time budget (env BENCH_BUDGET_S,
default 480 s) is spent.

Timing: ``utils.timing.bench`` — warmup, then the median of n calls each
ended by ``jax.block_until_ready``.  One process drives one GPU; it
refuses to run when JAX sees no GPU.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from hullwhite_tpu import HWConfig
from hullwhite_tpu import pricing
from hullwhite_tpu.backend import (card_info, default_engine,
                                   enable_compile_cache)
from hullwhite_tpu.ops.payoffs import cv_estimate
from hullwhite_tpu.utils.timing import bench

BASELINE_Q1 = 391e6     # V100 paths/s, reference README.md:12
BASELINE_Q2B = 1064e6   # reference README.md:44
BASELINE_Q3 = 509e6     # reference README.md:163

T0 = time.monotonic()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "480"))


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX sees {dev.platform}")
    cache_dir = enable_compile_cache()
    engine = default_engine()

    # Reference scale: 2^20 pairs, 1000 steps, 101 mats; every matmul in
    # true fp32 ("highest": no TF32).
    cfg = HWConfig(matmul_precision="highest", path_block=1 << 16)
    key = jax.random.key(cfg.seed)
    extras = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices()), "card": card_info(),
              "engine": engine,
              "matmul_precision": cfg.matmul_precision,
              "compile_cache": cache_dir}

    result = {}

    def emit():
        """(Re-)print the full JSON record and flush; the last complete
        line is the record."""
        result["elapsed_s"] = round(time.monotonic() - T0, 1)
        print(json.dumps(result), flush=True)

    def have_budget(section):
        if BUDGET_S - (time.monotonic() - T0) > 0:
            return True
        skipped = extras.setdefault("sections_skipped", [])
        skipped.append(section)
        result["sections_skipped"] = skipped
        return False

    # --- headline: Q1 curve bootstrap at 2^20 ---
    # prepared/run split: the sigma-dependent tables/weights build once
    # outside the timed loop, like the reference's compute_constants
    # before its cudaEvent window (1_bond_pricing.cu:49)
    prep_fn = pricing._curve_prep_fn(cfg, engine)
    jax.block_until_ready(prep_fn(cfg.sigma, cfg.sigma))
    extras["prep_ms"] = bench(prep_fn, cfg.sigma, cfg.sigma, n=5)[0] * 1e3
    prep = prep_fn(cfg.sigma, cfg.sigma)
    f = pricing._curve_sums_run_fn(cfg, engine, None)
    dt, sums = bench(f, key, prep)
    q1_paths_s = 2 * cfg.n_paths / dt
    P = sums / (2 * cfg.n_paths)
    extras["q1_ms"] = dt * 1e3
    extras["q1_P_0_10"] = float(P[-1])

    result.update({
        "metric": "Q1 curve bootstrap throughput "
                  "(2^20 antithetic path pairs x 1000 steps x 101 maturities)",
        "value": q1_paths_s,
        "unit": "paths/sec",
        "vs_baseline": q1_paths_s / BASELINE_Q1,
        **extras,
    })
    emit()

    # --- full-step tier: every SDE step's shock enters through one
    # (paths, 1000) x (1000, 101) fp32 matmul ---
    if have_budget("q1_fullstep"):
        prep_f = pricing._curve_prep_fn(cfg, "linear")(cfg.sigma, cfg.sigma)
        ff = pricing._curve_sums_run_fn(cfg, "linear", None)
        dtf, _ = bench(ff, key, prep_f, n=10)
        extras["q1_fullstep_ms"] = dtf * 1e3
        extras["q1_fullstep_paths_per_sec"] = 2 * cfg.n_paths / dtf
        extras["q1_fullstep_vs_v100"] = 2 * cfg.n_paths / dtf / BASELINE_Q1
        result.update(extras)
        emit()

    # --- Q2b / Q3 at 2^24 paths ---
    big = cfg.replace(n_paths=1 << 24, path_block=1 << 19)
    market = pricing.bootstrap_curve(cfg, key, engine=engine)
    if have_budget("q2b"):
        prep_z = pricing._option_prep_fn(big, engine, "zbc")(
            big.sigma, big.sigma, market)
        fz = pricing._option_run_fn(big, engine, "zbc", None)
        dtz, m = bench(fz, key, prep_z, market)
        est = cv_estimate(jnp.asarray(m), market.P[-1])
        extras["q2b_ms_2e24"] = dtz * 1e3
        extras["q2b_paths_per_sec"] = 2 * big.n_paths / dtz
        extras["q2b_vs_v100"] = 2 * big.n_paths / dtz / BASELINE_Q2B
        extras["q2b_price"] = float(est.price)
        extras["q2b_beta"] = float(est.beta)
        result.update(extras)
        emit()

    if have_budget("q3"):
        prep_v = pricing._option_prep_fn(big, engine, "vega")(
            big.sigma, big.sigma, market)
        fv = pricing._option_run_fn(big, engine, "vega", None)
        dtv, v = bench(fv, key, prep_v, market)
        extras["q3_ms_2e24"] = dtv * 1e3
        extras["q3_paths_per_sec"] = big.n_paths / dtv
        extras["q3_vs_v100"] = big.n_paths / dtv / BASELINE_Q3
        extras["q3_vega"] = float(v[0] / v[1])
        result.update(extras)
        emit()

    # RQMC evidence: option price SE at 2^16 points x 8 shifts
    if have_budget("qmc"):
        from hullwhite_tpu.ops.qmc import price_zbc_qmc

        res = price_zbc_qmc(cfg, key, market)
        extras["qmc_price"] = float(res.value)
        extras["qmc_se"] = float(res.std_error)
        result.update(extras)
        emit()

    # beyond-reference products (no V100 analogue exists): G2++ ZBC by
    # exact 3-normal sampling and the full Bermudan bracket (two-pass
    # LSMC + closed-form AB dual), both at 2^20 paths
    if have_budget("g2_zbc"):
        from hullwhite_tpu.models import g2pp

        g = g2pp.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)
        fg = g2pp._g2_zbc_fn(cfg, g, cfg.n_paths, 1, None)
        dtg, gout = bench(fg, key, market, n=10)
        extras["g2_zbc_ms"] = dtg * 1e3
        extras["g2_zbc_paths_per_sec"] = 2 * cfg.n_paths / dtg
        extras["g2_zbc_price"] = float(gout[0])
        result.update(extras)
        emit()
    if have_budget("bermudan"):
        from hullwhite_tpu import bermudan
        from hullwhite_tpu.instruments import swap_fixed_leg

        sched = swap_fixed_leg(cfg, 0.025, 5.0)
        ex = tuple(5.0 + j for j in range(5))
        fb = bermudan._bermudan_fn(cfg, ex, sched, 1.0, False, 1 << 17,
                                   8, False)
        dtb, bout = bench(fb, key, jnp.float32(cfg.sigma), market, n=3)
        extras["bermudan_ms"] = dtb * 1e3
        extras["bermudan_bracket"] = [float(bout[5]), float(bout[3])]
        extras["bermudan_raw_lower"] = float(bout[0])
        result.update(extras)
        emit()

    emit()


if __name__ == "__main__":
    main()
