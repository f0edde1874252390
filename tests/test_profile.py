"""Compile-report introspection (utils/profile.py) — untested in round 1."""

import jax.numpy as jnp
import pytest

from hullwhite_tpu.utils import profile as prof


def test_kernel_report_smoke():
    def f(x):
        return jnp.sum(jnp.dot(x, x, precision="highest"))

    x = jnp.ones((64, 64), jnp.float32)
    rep = prof.kernel_report(f, x)
    assert rep["device"]
    # CPU cost analysis reports flops for the matmul
    if rep.get("flops") is not None:
        assert rep["flops"] >= 2 * 64 ** 3 * 0.5
    s = prof.format_report(rep)
    assert "FLOPs" in s and "limiting factor" in s


H100 = "NVIDIA H100 80GB HBM3"


def _synthetic(flops, bts, **extra):
    return {"flops": flops, "bytes_accessed": bts,
            "peaks": prof.device_peaks(H100), **extra}


def test_limiting_factor_classification():
    ridge = 67e12 / 3350e9  # 20 flop/B: fp32 FFMA, the "highest" default
    lo = prof.limiting_factor(_synthetic(1e9, 1e9))   # AI 1 << ridge
    hi = prof.limiting_factor(_synthetic(1e15, 1e9))  # AI 1e6 >> ridge
    assert lo["factor"] == "HBM bandwidth"
    assert hi["factor"] == "compute"
    assert abs(lo["ridge_point"] - ridge) < 1e-6
    assert "fp32 ridge" in lo["detail"]


@pytest.mark.parametrize("precision,unit,tflops", [
    ("highest", "fp32", 67.0), ("default", "tf32", 495.0),
    ("tensorfloat32", "tf32", 495.0), ("bfloat16", "bf16", 989.0)])
def test_compute_peak_follows_matmul_precision(precision, unit, tflops):
    """An fp32 GEMM at HIGHEST is read against the fp32 peak, never the
    tensor-core rate: AI 100 flop/B is compute-bound for fp32 and
    TF32 (ridge 148) would call it bandwidth-bound."""
    rep = _synthetic(100e9, 1e9, matmul_precision=precision)
    assert prof.compute_peak(rep) == (unit, tflops)
    lf = prof.limiting_factor(rep, time_s=None)
    assert lf["ridge_point"] == pytest.approx(tflops * 1e12 / 3350e9)
    assert lf["factor"] == ("compute" if unit == "fp32" else "HBM bandwidth")
    assert f"% of {unit} peak" in prof.format_report(rep, time_s=1e-3)


def test_limiting_factor_with_timing():
    # 1 ms kernel doing 500 Tflop-equivalents -> compute-bound
    r = prof.limiting_factor(_synthetic(500e9, 1e6), time_s=1e-3)
    assert r["factor"] == "compute"
    assert r["compute_utilization"] > r["hbm_utilization"]
    # same bytes at trivial flops -> bandwidth-bound
    r2 = prof.limiting_factor(_synthetic(1e6, 800e6), time_s=1e-3)
    assert r2["factor"] == "HBM bandwidth"


def test_limiting_factor_unknown_device():
    r = prof.limiting_factor({"flops": 1.0, "bytes_accessed": 1.0})
    assert r["factor"] == "unknown"


def test_h100_peaks_keyed_on_exact_device_kind():
    """The data-sheet row (fp32, dense TF32/bf16, HBM3) for the exact
    device_kind."""
    assert prof.device_peaks(H100) == {"fp32_tflops": 67.0,
                                       "tf32_tflops": 495.0,
                                       "bf16_tflops": 989.0,
                                       "hbm_gbps": 3350.0}
    # no substring matching: a near miss is an unknown device
    assert prof.device_peaks("NVIDIA H100") is None


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "Some Future Accelerator"])
def test_unknown_device_gets_no_peaks(kind):
    assert prof.device_peaks(kind) is None
    rep = {"flops": 1e9, "bytes_accessed": 1e9, "device_kind": kind}
    assert prof.limiting_factor(rep)["factor"] == "unknown"
    assert f"none for {kind!r}" in prof.format_report(rep)
