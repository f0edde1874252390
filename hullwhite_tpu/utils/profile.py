"""Compiled-kernel introspection — the analogue of the reference's CUDA
occupancy analyzer (3_sensitivity_analysis.cu:183-239, C34), which
reported registers/thread, shared-memory usage, spilling and theoretical
occupancy before launching the hot kernel.

Here the pre-flight introspection is the XLA compile report: FLOPs and
transcendentals from ``cost_analysis`` and the argument/output/temp/code
footprint from ``memory_analysis``; "occupancy" is replaced by
arithmetic intensity and roofline utilization against the device's
published peaks.
"""

from __future__ import annotations

from typing import Any

import jax

# Published dense peaks, keyed on the exact ``device_kind`` JAX reports.
# Source: NVIDIA H100 SXM data sheet (fp32 without tensor cores; TF32
# and bf16 tensor-core rates without sparsity; HBM3 bandwidth).  A device
# not in this table gets no peaks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_tflops": 67.0, "tf32_tflops": 495.0,
                              "bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}

# The unit a float32 matmul runs on at each ``HWConfig.matmul_precision``:
# "highest" is true fp32 (FFMA), "default"/"high" allow TF32 on the card.
PRECISION_UNIT = {"highest": "fp32", "float32": "fp32",
                  "high": "tf32", "tensorfloat32": "tf32", "default": "tf32",
                  "bfloat16": "bf16"}


def device_peaks(device_kind: str):
    """Peak table row for ``device_kind``, or None when unknown."""
    return PEAKS.get(device_kind)


def compute_peak(report: dict[str, Any]) -> tuple[str, float]:
    """(unit, TFLOP/s) the report's matmuls run against, chosen by its
    ``matmul_precision`` (the package default, "highest", when absent)."""
    unit = PRECISION_UNIT[report.get("matmul_precision", "highest")]
    return unit, report["peaks"][f"{unit}_tflops"]


def kernel_report(fn, *args, static_argnums=(),
                  matmul_precision: str = "highest") -> dict[str, Any]:
    """Lower + compile ``fn`` on ``args`` and extract the compile report;
    ``matmul_precision`` is the precision ``fn``'s matmuls were traced at
    (it picks the compute peak)."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn,
                                                     static_argnums=static_argnums)
    compiled = jitted.lower(*args).compile()
    cost = compiled.cost_analysis() or {}
    try:
        mem = compiled.memory_analysis()
    except Exception:  # noqa: BLE001 - backend-dependent
        mem = None

    report: dict[str, Any] = {
        "flops": cost.get("flops"),
        "transcendentals": cost.get("transcendentals"),
        "bytes_accessed": cost.get("bytes accessed"),
    }
    if mem is not None:
        for field in ("argument_size_in_bytes", "output_size_in_bytes",
                      "temp_size_in_bytes", "generated_code_size_in_bytes"):
            report[field] = getattr(mem, field, None)
    dev = jax.devices()[0]
    report["device"] = str(dev)
    report["device_kind"] = dev.device_kind
    report["matmul_precision"] = matmul_precision
    peaks = device_peaks(dev.device_kind)
    if peaks is not None:
        report["peaks"] = peaks
    if (report.get("peaks") and report.get("flops")
            and report.get("bytes_accessed")):
        report["arithmetic_intensity_flops_per_byte"] = (
            report["flops"] / max(report["bytes_accessed"], 1.0))
    return report


def limiting_factor(report: dict[str, Any],
                    time_s: float | None = None) -> dict[str, Any]:
    """Name the resource that bounds the kernel — the analogue of the
    reference analyzer's 'limiting factor' line (it reports which of
    registers/shared-memory/blocks caps occupancy,
    3_sensitivity_analysis.cu:183-239).

    Pre-flight (no timing): classify by arithmetic intensity against the
    device's roofline ridge point.  With a measured ``time_s``: compute
    both achieved utilizations and name the higher one.
    """
    peaks = report.get("peaks")
    flops = report.get("flops")
    bts = report.get("bytes_accessed")
    if not peaks or not flops or not bts:
        return {"factor": "unknown",
                "detail": "no peak table or cost analysis for this device"}
    unit, tflops = compute_peak(report)
    ridge = tflops * 1e12 / (peaks["hbm_gbps"] * 1e9)
    ai = flops / max(bts, 1.0)
    if time_s:
        comp = flops / time_s / (tflops * 1e12)
        hbm = bts / time_s / (peaks["hbm_gbps"] * 1e9)
        factor = "compute" if comp >= hbm else "HBM bandwidth"
        return {"factor": factor, "compute_utilization": comp,
                "hbm_utilization": hbm,
                "detail": f"achieved {comp:.1%} of {unit} peak, "
                          f"{hbm:.1%} of HBM peak"}
    factor = "compute" if ai >= ridge else "HBM bandwidth"
    return {"factor": factor, "arithmetic_intensity": ai,
            "ridge_point": ridge,
            "detail": f"AI {ai:.1f} flop/B vs {unit} ridge "
                      f"{ridge:.1f} flop/B"}


def format_report(report: dict[str, Any], time_s: float | None = None) -> str:
    """Human-readable block, printed by the CLI before the hot launch
    (mirrors the reference's 'CUDA Kernel Analysis' section)."""
    lines = ["XLA kernel analysis"]

    def fmt(v, unit=""):
        if v is None:
            return "n/a"
        if v > 1e9:
            return f"{v/1e9:.2f} G{unit}"
        if v > 1e6:
            return f"{v/1e6:.2f} M{unit}"
        return f"{v:.0f} {unit}"

    lines.append(f"  FLOPs:                {fmt(report.get('flops'))}")
    lines.append(f"  transcendentals:      {fmt(report.get('transcendentals'))}")
    lines.append(f"  bytes accessed (HBM): {fmt(report.get('bytes_accessed'), 'B')}")
    for k, label in [("argument_size_in_bytes", "argument bytes"),
                     ("output_size_in_bytes", "output bytes"),
                     ("temp_size_in_bytes", "temp (scratch) bytes"),
                     ("generated_code_size_in_bytes", "code size")]:
        if report.get(k) is not None:
            lines.append(f"  {label + ':':22s}{fmt(report[k], 'B')}")
    ai = report.get("arithmetic_intensity_flops_per_byte")
    if ai is not None:
        lines.append(f"  arithmetic intensity: {ai:.1f} flop/byte")
    if time_s and report.get("peaks"):
        p = report["peaks"]
        if report.get("flops"):
            unit, tflops = compute_peak(report)
            util = report["flops"] / time_s / (tflops * 1e12) * 100
            lines.append(f"  compute utilization:  {util:.1f}% of {unit} peak")
        if report.get("bytes_accessed"):
            bw = report["bytes_accessed"] / time_s / (p["hbm_gbps"] * 1e9) * 100
            lines.append(f"  HBM utilization:      {bw:.1f}% of peak")
    if "peaks" not in report:
        lines.append(f"  peaks:                none for "
                     f"{report.get('device_kind', '?')!r} (not in the table)")
    lf = limiting_factor(report, time_s)
    lines.append(f"  limiting factor:      {lf['factor']} ({lf['detail']})")
    return "\n".join(lines)
