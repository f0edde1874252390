"""Accurate fp32 transcendentals for on-device estimator evaluation.

Why this exists: an accelerator's native fp32 ``exp`` was measured at up
to 40 ulp error with a SYSTEMATIC −8.4e-7 mean relative bias over the
Bermudan argument range (CPU fp32: 0.65 ulp, −1.5e-9 — effectively
unbiased).  The Bermudan bracket estimators
compose several exponentials per term (bond values e^{-B r}, discounts
e^{-I}, tilting weights e^{-m+v/2}), so the hardware bias accumulated
into the documented −2e-6 absolute floor on both bracket sides — the
CPU fp32 twin of the same estimator matches the fp64 oracle to 1.5e-7.

``exp32`` is a classical Cody–Waite + polynomial exp evaluated in plain
fp32 arithmetic (mul/add/round/bitcast only — nothing XLA lowers to the
hardware transcendental):

* range reduction r = x − k·ln2 with the two-term constant
  (C1 exact in fp32, C2 the fp64 remainder), k = round(x·log2 e);
* degree-7 Taylor/Horner on |r| ≤ ln2/2 (truncation 5.2e-9 relative);
* scale by 2^k via exponent-field bitcast.

Max relative error ~2 ulp, mean bias ~1e-9 — hardware-independent, so
device fp32 == CPU fp32 to ~1e-7 and the bracket quote needs no device
allowance (gpu_tests/test_accurate.py pins it on the card; chip_smoke.py
prints the card's native exp error beside it).

``nphi``/``npdf`` are the Gaussian CDF/PDF companions: the native CDF
was measured fine on an accelerator (2.3e-7 max abs, −5e-10 bias — it is a
polynomial erf, not the hardware exp), so ``nphi`` simply forwards to
it; the PDF inherits the exp bias, so ``npdf`` routes through
``exp32``.

Used by the Bermudan bracket paths (bermudan.py, models/g2pp.py).
Reference anchor: the reference validates sensitivities only at fp32
hardware accuracy (src/3_sensitivity_analysis.cu:656-695); this removes
the equivalent floor from the rebuild's flagship accuracy product.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.stats import norm as _jnorm

# ln2 = C1 + C2 with C1 exactly representable in fp32 (Cody–Waite):
# float32(0.693359375) is exact; C2 = ln2 - C1 in fp64.
_LOG2E = 1.4426950408889634
_C1 = 0.693359375
_C2 = -2.121944400546905e-04
_INV = [1.0, 1.0, 0.5, 1.0 / 6.0, 1.0 / 24.0, 1.0 / 120.0, 1.0 / 720.0,
        1.0 / 5040.0]


def exp32(x):
    """Accurate fp32 e^x (|x| ≲ 85; ~2 ulp, unbiased — see module doc).

    Arguments far outside the Bermudan range are clamped at the 2^k
    scaling (k in [-126, 126]), which keeps the result finite and
    monotone rather than overflowing the exponent-field bitcast.
    """
    x = jnp.asarray(x, jnp.float32)
    k = jnp.round(x * jnp.float32(_LOG2E))
    r = (x - k * jnp.float32(_C1)) - k * jnp.float32(_C2)
    # Horner degree-7: truncation 5e-9 relative on |r| <= ln2/2
    p = jnp.float32(_INV[7])
    for c in (_INV[6], _INV[5], _INV[4], _INV[3], _INV[2], _INV[1],
              _INV[0]):
        p = p * r + jnp.float32(c)
    ki = jnp.clip(k, -126.0, 126.0).astype(jnp.int32)
    scale = jax_bitcast_pow2(ki)
    return p * scale


def jax_bitcast_pow2(ki):
    """2^ki for int32 ki in [-126, 126] via the fp32 exponent field."""
    return jnp.asarray((ki + 127) << 23, jnp.int32).view(jnp.float32)


def nphi(x):
    """Standard normal CDF (native: measured accurate on device)."""
    return _jnorm.cdf(x)


def npdf(x):
    """Standard normal PDF through exp32 (the native PDF carries the
    hardware exp bias)."""
    x = jnp.asarray(x, jnp.float32)
    return jnp.float32(0.3989422804014327) * exp32(-0.5 * x * x)
