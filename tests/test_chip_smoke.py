"""chip_smoke.py on the CPU: it refuses to run without a GPU, its last
line is exactly the contract's, its tolerance checks do what they say,
--four-cards selects only the mesh phase, and that phase passes on a
virtual CPU mesh at a small size."""

import json
import math
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import chip_smoke as cs
from hullwhite_tpu import backend, tiny_config

REPO = backend.REPO_ROOT


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--four-cards",)],
                         ids=["one_card", "four_cards"])
def test_refuses_without_gpu(args):
    r = _run(REPO, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs" in r.stderr


def test_refuses_outside_the_repo(tmp_path):
    """Alone in a directory, even with JAX made to report a GPU, the
    script fails before any phase: it runs the package beside it."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    code = ("import runpy, sys, types, jax; "
            "jax.devices = lambda *a: [types.SimpleNamespace("
            "platform='gpu', device_kind='fake')]; "
            "sys.argv = ['chip_smoke.py']; "
            "runpy.run_path('chip_smoke.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "No module named 'hullwhite_tpu'" in r.stderr


def test_last_line_is_exactly_the_contract():
    devs = [types.SimpleNamespace(platform="gpu",
                                  device_kind="NVIDIA H100 80GB HBM3")] * 4
    line = cs.last_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_gate_close_and_below():
    g = cs.Gate("t")
    assert g.close("a", 1.0, 1.05, 0.1)
    assert g.below("b", 1e-7, 1e-6)
    assert g.ok and "[t] ok" in g.line()
    assert not g.close("c", 1.0, 1.2, 0.1)
    assert not g.ok and "FAIL" in g.line()


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_gate_rejects_non_finite(value):
    g = cs.Gate("t")
    assert not g.close("a", value, 0.0, 1.0)
    assert not g.below("b", value, 1.0)
    assert not g.ok


def test_curve_standard_errors_match_a_direct_estimate():
    """The closed-form SE of the antithetic-pair estimator agrees with
    the sample SE of exp(-c) cosh(z) drawn from the same law."""
    from hullwhite_tpu.models import hull_white as hw
    from hullwhite_tpu.ops import engine_exact

    cfg = tiny_config(n_paths=1 << 14)
    P_or = np.ones(cfg.n_mat)
    se = cs.curve_standard_errors(cfg, P_or)
    assert se[0] == 0.0 and np.all(se[1:] > 0)
    LT = engine_exact.curve_chol(cfg).astype(np.float64)
    s = cfg.sigma * hw.sig_st_unit(cfg) * np.sqrt(np.sum(LT ** 2, axis=0))
    z = np.random.default_rng(0).standard_normal((1 << 16, 1)) * s[None, :]
    pair = np.exp(-s ** 2 / 2) * np.cosh(z)        # P_or = 1
    direct = pair.std(axis=0) / math.sqrt(cfg.n_paths)
    np.testing.assert_allclose(se[1:], direct, rtol=0.05)


def test_max_ulp_error():
    ref = np.array([1.0, 2.0], np.float64)
    vals = ref + np.spacing(np.float32(ref)).astype(np.float64) * [1, 3]
    assert cs.max_ulp_error(vals, ref) == pytest.approx(3.0)


def test_run_counts_a_raising_phase_as_failed(capsys):
    class _Ok:
        ok = True

    def boom():
        raise RuntimeError("x")

    assert cs.run([("a", _Ok)])
    assert not cs.run([("a", _Ok), ("b", boom), ("c", _Ok)])
    out = capsys.readouterr().out
    assert "[b] FAIL: raised" in out and "[c]" in out


@pytest.mark.parametrize("four_cards,names", [
    (True, ["device", "mesh"]),
    (False, ["device", "q1", "q2", "q3", "gpu_vs_cpu", "bermudan"]),
], ids=["four_cards", "one_card"])
def test_phase_selection(four_cards, names):
    cfg = tiny_config()
    phases = cs.build_phases(four_cards, cfg, jax.random.key(0),
                             jax.devices(), "cache")
    assert [n for n, _ in phases] == names


def test_mesh_phase_passes_on_a_cpu_mesh():
    """The --four-cards path, rehearsed on four virtual CPU devices."""
    from hullwhite_tpu.parallel import mesh as pmesh

    mesh = pmesh.path_mesh(jax.devices()[:4])
    cfg = tiny_config(n_paths=8 * 1024, path_block=1024)
    g = cs.phase_mesh(cfg, jax.random.key(0), mesh, berm_paths=512,
                      berm_blocks=4, berm_rights=1)
    assert g.ok, g.line()
    assert {r[0] for r in g.rows} >= {"curve", "zbc", "vega", "grid",
                                      "bermudan_lower", "bermudan_upper"}


def test_gpu_vs_cpu_phase_runs_on_the_cpu():
    """On a CPU-only host both sides are the CPU: the comparison machinery
    runs and agrees exactly."""
    cfg = tiny_config(n_paths=1 << 11, path_block=1 << 10)
    g = cs.phase_gpu_vs_cpu(cfg)
    assert g.ok, g.line()


@pytest.mark.parametrize("engine", ["exact", "linear"])
def test_path_values_are_per_path(engine):
    """Each curve path's two-leg discount sums (the maturity-0 column is
    2) and the ZBC shocks: one row per path, finite, shocks centred."""
    cfg = tiny_config()
    legs, z = (np.asarray(a) for a in cs.path_values(
        cfg, engine, jax.random.key(0), 512))
    assert legs.shape == (512, cfg.n_mat) and z.shape == (512, 2)
    assert np.all(legs[:, 0] == 2.0) and np.all(legs[:, 1:] > 0)
    assert np.all(np.isfinite(z)) and np.all(z.std(axis=0) > 0)
    assert np.all(np.abs(z.mean(axis=0)) < 4 * z.std(axis=0) / np.sqrt(512))
