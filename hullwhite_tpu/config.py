"""Simulation configuration.

JAX replacement for the reference's compile-time configuration
(`include/common.cuh:15-57` — ``N_PATHS``/``N_STEPS``/``NTPB``/``N_MAT`` macros,
host model constants and the ``__constant__``-memory bank).  Instead of
preprocessor macros + CUDA constant memory we use a frozen, hashable
dataclass that is passed as a *static* argument to jitted functions, so XLA
specializes every kernel on the configuration exactly like ``nvcc`` did on
the ``#define``s.

There is no thread-block geometry here: the path axis is tiled by
``path_block`` (the per-device block of paths one loop iteration draws and
reduces) and sharded over the device mesh (see ``hullwhite_tpu.parallel``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ThetaSpec:
    """Piecewise-linear ground-truth drift theta(t) = alpha + beta * t.

    Default is the CONTINUOUS spec theta(t) = 0.012 + 0.0014 t (t < 5),
    0.014 + 0.001 t (t >= 5); note 0.012 + 0.0014*5 = 0.019 = 0.014 + 0.001*5.

    Reference-discrepancy note: the mounted reference's ``theta_func``
    (common.cuh:228-230) and ``compute_drift_tables`` (common.cuh:74-76) use
    0.019 + 0.001 t for the second piece — a *discontinuous* theta (jump
    0.019 -> 0.024 at t=5) — while ``compute_shifted_drift_table``
    (3_sensitivity_analysis.cu:385-387) uses 0.014.  Reproducing the
    published results settles which is intended: the README numbers
    (P(0,10)=0.876844, ZBC=0.03549203, vega=0.230189) are reproduced in
    float64 ONLY by the continuous 0.014 spec (the 0.019 table gives
    P(0,10)=0.859386, 2% off — far beyond the published MC noise).  The
    0.019 coefficient is therefore a later regression in the reference
    source; per SURVEY §7 we reproduce the *behavioral outcomes*, so the
    continuous spec is the default.  Pass ``alpha1=0.019`` to match the
    mounted source instead.
    """

    alpha0: float = 0.012
    beta0: float = 0.0014
    alpha1: float = 0.014
    beta1: float = 0.001
    t_break: float = 5.0


@dataclass(frozen=True)
class ThetaFromCurve:
    """Market-implied drift: theta(t) = df/dT + a f(t) + sigma^2/(2a)
    (1 - e^{-2at}) with f the OBSERVED instantaneous-forward curve — the
    textbook Hull-White fit that makes the model reprice the input curve
    exactly at the config's (a, sigma) (round-5; the closed forms price
    off the curve directly, so calibrated-parameter Monte Carlo must
    too, or model-vs-market drift biases every curve-sensitive product
    — measured +1.8e-3 on a 4y cap at (a, sigma) = (0.85, 0.093) under
    the default hard-coded ThetaSpec).

    Carries the fp64 forward curve tabulated on the maturity grid
    (hashable tuple => jit-static config field).  The drift-kernel
    integral needs no numerical f': d/du[f(u) e^{-a(t-u)}] =
    (f' + a f) e^{-a(t-u)}, so int_s^t e^{-a(t-u)} (f' + a f) du =
    f(t) - E f(s) exactly, and the convexity term is sigma0^2/2 times
    the existing psi kernel — the canonical drift = base +
    0.5 (sigma^2 - sigma0^2) psi form (and with it CRN, the vega
    tangent and jax.jvp) is preserved.  Build with
    ``hull_white.market_theta``.  Note the sigma-shift semantics: under
    a market spec the curve fit holds at EVERY sigma (theta re-fits),
    matching the reference's 'recalibrated' FD mode rather than its
    fixed-theta mode."""

    f: tuple                 # fp64 forward curve on the maturity grid
    t_final: float = 10.0


@dataclass(frozen=True)
class HWConfig:
    """Hull-White Monte Carlo configuration (frozen & hashable => jit-static).

    ``n_paths`` counts *antithetic pairs*: each logical path contributes two
    trajectories driven by +G and -G, so the effective sample count is
    ``2 * n_paths`` (reference ``market_data.cuh:38-55``).
    """

    # Monte Carlo sizes (reference common.cuh:16-29)
    n_paths: int = 1 << 20
    n_steps: int = 1000
    n_mat: int = 101
    t_final: float = 10.0

    # Hull-White model parameters (reference common.cuh:31-39)
    a: float = 1.0
    sigma: float = 0.1
    r0: float = 0.012
    theta: ThetaSpec = ThetaSpec()

    # ZBC option contract (reference 2_option_pricing.cu:108-110)
    s1: float = 5.0
    s2: float = 10.0
    strike: float = math.exp(-0.1)

    # Execution parameters (no CUDA analogue)
    path_block: int = 1 << 15  # antithetic pairs per streamed block
    dtype: str = "float32"     # path-state dtype ("float32" | "bfloat16" G)
    # Precision of the shock matmuls: "highest" = true fp32.  A GPU runs
    # an fp32 matmul that names no precision in TF32 (about three decimal
    # digits), which is NOT enough for 6-significant-digit curve
    # reproduction — keep "highest" unless the statistical gates are
    # re-verified on the card.
    matmul_precision: str = "highest"
    seed: int = 0

    def __post_init__(self):
        if self.n_steps % (self.n_mat - 1) != 0:
            # Static check mirroring the reference's #error guard
            # (common.cuh:25-27).
            raise ValueError("n_steps must be divisible by (n_mat - 1)")
        if self.n_paths % self.path_block != 0:
            raise ValueError("n_paths must be divisible by path_block")

    # ---- derived quantities (reference common.cuh:29-34) ----
    @property
    def dt(self) -> float:
        return self.t_final / self.n_steps

    @property
    def mat_spacing(self) -> float:
        return self.t_final / (self.n_mat - 1)

    @property
    def save_stride(self) -> int:
        return self.n_steps // (self.n_mat - 1)

    @property
    def n_steps_s1(self) -> int:
        """Steps to reach the option exercise date S1 (must land on grid)."""
        n1 = int(round(self.s1 / self.dt))
        return n1

    @property
    def n_blocks(self) -> int:
        return self.n_paths // self.path_block

    def replace(self, **kw) -> "HWConfig":
        return dataclasses.replace(self, **kw)


# Small CPU-friendly configuration used by tests and the multichip dry run.
def tiny_config(**kw) -> HWConfig:
    base = dict(
        n_paths=1 << 12,
        n_steps=100,
        n_mat=11,
        path_block=1 << 10,
    )
    base.update(kw)
    return HWConfig(**base)
