"""I/O, persistence & reporting — schema-compatible with the reference.

Replaces ``include/output.cuh`` (C33) and the binary market-data handoff
(C41, ``save_array``/``load_array`` of data/P.bin, data/f.bin): Q1 persists
the bootstrapped curves, Q2/Q3/benchmarks load them; results are written as
JSON with the reference's parameter header, CSV timeseries/comparisons, and
a cumulative ``summary.txt``, so tooling written against the reference's
``data/`` directory keeps working.

When the optional C++ native writer library is built
(native/, loaded via ctypes) the hot array serialization goes through it;
otherwise the pure-Python implementation is used.  Behaviour is identical.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from ..config import HWConfig
from ..models.hull_white import MarketCurve

DATA_DIR = Path("data")


def _native():
    from . import native  # deferred: optional compiled library

    return native if native.available() else None


def ensure_dir(path=DATA_DIR):
    Path(path).mkdir(parents=True, exist_ok=True)
    return Path(path)


# --- market-data handoff (reference common.cuh:144-176) -------------------

def save_market(cfg: HWConfig, market: MarketCurve, path=None):
    path = Path(path or DATA_DIR / "market.npz")
    ensure_dir(path.parent)
    np.savez(path, P=np.asarray(market.P, np.float32),
             f=np.asarray(market.f, np.float32),
             n_mat=cfg.n_mat, t_final=cfg.t_final)
    # also emit raw fp32 .bin files byte-compatible with the reference
    save_bin(path.parent / "P.bin", np.asarray(market.P, np.float32))
    save_bin(path.parent / "f.bin", np.asarray(market.f, np.float32))
    return path


def load_market(cfg: HWConfig, path=None) -> MarketCurve:
    import jax.numpy as jnp

    path = Path(path or DATA_DIR / "market.npz")
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found. Did you run Q1 first? "
            "(python -m hullwhite_tpu.cli q1)")
    z = np.load(path)
    if int(z["n_mat"]) != cfg.n_mat:
        raise ValueError(
            f"market data has n_mat={int(z['n_mat'])}, config wants {cfg.n_mat}")
    return MarketCurve(P=jnp.asarray(z["P"]), f=jnp.asarray(z["f"]))


def save_bin(path, arr: np.ndarray):
    """Raw little-endian fp32 dump (format of reference save_array)."""
    n = _native()
    if n is not None:
        n.save_bin(str(path), np.ascontiguousarray(arr, np.float32))
    else:
        np.ascontiguousarray(arr, np.float32).tofile(path)


def load_bin(path, n_items: int) -> np.ndarray:
    arr = np.fromfile(path, dtype=np.float32, count=n_items)
    if len(arr) != n_items:
        raise ValueError(f"expected {n_items} floats in {path}, got {len(arr)}")
    return arr


# --- JSON results (reference output.cuh:8-60) ------------------------------

def _param_header(cfg: HWConfig):
    return {
        "N_PATHS": cfg.n_paths,
        "N_STEPS": cfg.n_steps,
        "N_MAT": cfg.n_mat,
        "T_FINAL": cfg.t_final,
        "a": cfg.a,
        "sigma": cfg.sigma,
        "r0": cfg.r0,
    }


def write_json(path, task: str, cfg: HWConfig, results: dict,
               performance: dict | None = None, arrays: dict | None = None):
    doc = {
        "task": task,
        "timestamp": time.strftime("%a %b %d %H:%M:%S %Y"),
        "parameters": _param_header(cfg),
    }
    if arrays:
        doc.update({k: np.asarray(v, np.float64).round(8).tolist()
                    for k, v in arrays.items()})
    if performance:
        doc["performance"] = performance
    doc["results"] = results
    ensure_dir(Path(path).parent)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return path


def performance_block(time_ms: float, n_paths: int):
    """Schema of json_write_performance (output.cuh:53-60), plus the
    device the time was measured on."""
    import jax

    dev = jax.devices()[0]
    return {
        "simulation_time_ms": round(time_ms, 3),
        "throughput_Mpaths_per_sec": round(n_paths / time_ms / 1e3, 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
    }


# --- CSV writers (reference output.cuh:62-96) ------------------------------

def csv_timeseries(path, header: str, data, spacing: float):
    ensure_dir(Path(path).parent)
    n = _native()
    arr = np.asarray(data, np.float64)
    if n is not None:
        n.csv_timeseries(str(path), header, arr.astype(np.float32), spacing)
        return path
    with open(path, "w") as f:
        f.write(f"T,{header}\n")
        for i, v in enumerate(arr):
            f.write(f"{i * spacing:.4f},{v:.8f}\n")
    return path


def csv_comparison(path, x, y1, y2, names):
    ensure_dir(Path(path).parent)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for xi, a, b in zip(np.asarray(x), np.asarray(y1), np.asarray(y2)):
            f.write(f"{xi:.4f},{a:.8f},{b:.8f}\n")
    return path


def csv_rows(path, header: list, rows):
    ensure_dir(Path(path).parent)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(f"{v:.10f}" if isinstance(v, float) else str(v)
                             for v in row) + "\n")
    return path


# --- cumulative summary (reference output.cuh:128-167) ---------------------

def summary_init(cfg: HWConfig, path=None):
    path = Path(path or DATA_DIR / "summary.txt")
    ensure_dir(path.parent)
    bar = "=" * 80
    with open(path, "w") as f:
        f.write(f"{bar}\nHULL-WHITE MODEL SIMULATION RESULTS (hullwhite_tpu)\n{bar}\n")
        f.write(f"Generated: {time.ctime()}\n\n")
        f.write("Parameters:\n")
        f.write(f"  N_PATHS = {cfg.n_paths} (x2 antithetic = {2 * cfg.n_paths} effective)\n")
        f.write(f"  N_STEPS = {cfg.n_steps}\n  N_MAT = {cfg.n_mat}\n")
        f.write(f"  T_FINAL = {cfg.t_final} years\n")
        f.write(f"  a = {cfg.a}, sigma = {cfg.sigma}, r0 = {cfg.r0}\n")
    return path


def summary_append(section: str, lines, path=None):
    path = Path(path or DATA_DIR / "summary.txt")
    ensure_dir(path.parent)
    bar = "=" * 80
    with open(path, "a") as f:
        f.write(f"\n{bar}\n{section}\n{bar}\n")
        for line in lines:
            f.write(f"  {line}\n")
    return path
