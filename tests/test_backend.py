"""One backend choice (backend.py): default engine per platform, engines
each product accepts, the compile-cache location, and mesh provisioning
that never turns an accelerator run into a CPU run."""

import os
import types

import jax
import pytest

from hullwhite_tpu import backend, grid, pricing, tiny_config

REMOVED = ("pallas", "pallas_exact", "triton_exact")


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_default_engine_per_platform(platform):
    assert backend.default_engine(platform) == "exact"


@pytest.mark.parametrize("platform", ["neuron", "rocm", "metal", "unknown"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no engine for platform"):
        backend.default_engine(platform)


def test_default_platform_is_the_first_device():
    assert backend.default_engine() == backend.default_engine(
        jax.devices()[0].platform)


@pytest.mark.parametrize("engine", backend.ENGINES)
def test_check_engine_accepts_every_xla_engine(engine):
    assert backend.check_engine(engine) == engine


def test_engine_list_holds_only_xla_engines():
    assert pricing.ENGINES == ("linear", "scan", "exact")


@pytest.fixture(scope="module")
def market():
    cfg = tiny_config()
    return cfg, pricing.bootstrap_curve(cfg, jax.random.key(0))


_CALLS = {
    "curve": lambda cfg, key, m, e: pricing.bootstrap_curve(cfg, key,
                                                            engine=e),
    "curve_pricer": lambda cfg, key, m, e: pricing.curve_pricer(
        cfg, engine=e).prepare(cfg.sigma, cfg.sigma),
    "zbc": lambda cfg, key, m, e: pricing.price_zbc(cfg, key, m, engine=e),
    "vega": lambda cfg, key, m, e: pricing.pathwise_vega(cfg, key, m,
                                                         engine=e),
    "delta": lambda cfg, key, m, e: pricing.pathwise_delta(cfg, key, m,
                                                           engine=e),
    "zbc_pricer": lambda cfg, key, m, e: pricing.zbc_pricer(
        cfg, engine=e).prepare(cfg.sigma, cfg.sigma, m),
}


@pytest.mark.parametrize("call", sorted(_CALLS))
@pytest.mark.parametrize("engine", REMOVED)
def test_removed_engine_names_raise(engine, call, market):
    """A kernel tier that no longer exists is an error on every product,
    never a silent switch to an XLA engine."""
    cfg, m = market
    with pytest.raises(ValueError, match="unknown engine"):
        _CALLS[call](cfg, jax.random.key(1), m, engine)


@pytest.mark.parametrize("fn", [grid.price_zbc_grid, grid.vega_zbc_grid],
                         ids=["price", "vega"])
@pytest.mark.parametrize("engine", ["pallas", "pallas_exact"])
def test_grid_never_swaps_engines_silently(fn, engine, market):
    """The grid vega used to replace a kernel engine by 'exact' without a
    word; an engine name without an implementation now raises."""
    cfg, m = market
    with pytest.raises(ValueError, match="unknown engine"):
        fn(cfg, jax.random.key(1), m, [0.9], [10.0], engine=engine)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper configures nothing
    (JAX reads the variable itself) and reports that directory."""
    monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
    calls = []
    monkeypatch.setattr(backend.jax.config, "update",
                        lambda *a: calls.append(a))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(backend.CACHE_ENV, raising=False)
    calls = []
    monkeypatch.setattr(backend.jax.config, "update",
                        lambda *a: calls.append(a))
    path = backend.enable_compile_cache()
    assert path == os.path.join(backend.REPO_ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
    # never a temp dir, a pid or a time: the same path on every call
    assert not path.startswith("/tmp")
    assert str(os.getpid()) not in path
    assert backend.enable_compile_cache() == path
    assert os.path.isfile(os.path.join(backend.REPO_ROOT, ".gitignore"))
    with open(os.path.join(backend.REPO_ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_card_info_reports_every_card(monkeypatch, tmp_path):
    """One ``name, power.limit`` line per card, as nvidia-smi prints it."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 400.00 W'\n"
                   "echo 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert backend.card_info().splitlines() == [
        "NVIDIA H100 80GB HBM3, 400.00 W", "NVIDIA H100 80GB HBM3, 700.00 W"]


def test_card_info_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))      # holds no nvidia-smi
    assert backend.card_info().startswith("nvidia-smi unavailable")


def _fake_gpus(n):
    return [types.SimpleNamespace(platform="gpu", device_kind="fake", id=i)
            for i in range(n)]


def test_mesh_devices_on_cpu_returns_requested_count():
    assert len(backend.mesh_devices(4)) == 4


def test_mesh_devices_refuses_too_few_accelerators(monkeypatch):
    monkeypatch.setattr(backend.jax, "devices", lambda *a: _fake_gpus(1))
    with pytest.raises(RuntimeError, match="need 4 gpu devices"):
        backend.mesh_devices(4)


def test_cmd_sweep_refuses_too_few_accelerators(monkeypatch):
    from hullwhite_tpu import cli_products

    monkeypatch.setattr(jax, "devices", lambda *a: _fake_gpus(1))
    args = types.SimpleNamespace(mesh=4, paths=1 << 12, seed=None,
                                 engine=None, reps=1)
    with pytest.raises(RuntimeError, match="need 4 gpu devices"):
        cli_products.cmd_sweep(args)


def test_dryrun_multichip_refuses_too_few_accelerators(monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry_backend_test",
        os.path.join(backend.REPO_ROOT, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    monkeypatch.setattr(jax, "devices", lambda *a: _fake_gpus(2))
    monkeypatch.setattr(backend, "enable_compile_cache", lambda: "x")
    with pytest.raises(RuntimeError, match="need 4 gpu devices"):
        g.dryrun_multichip(4)


def _dot_precisions(jaxpr):
    """precision param of every dot_general in a (nested) jaxpr."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


@pytest.mark.parametrize("engine", ["exact", "linear"])
def test_main_path_matmuls_name_their_precision(engine, market):
    """Every matmul of Q1/Q2/Q3 names its precision: HIGHEST (true fp32),
    never the platform default (TF32 on a GPU)."""
    cfg, m = market
    key = jax.random.key(3)
    fns = [
        (pricing._curve_sums_fn(cfg, engine, None), (key, cfg.sigma,
                                                     cfg.sigma)),
        (pricing._zbc_moments_fn(cfg, engine, None),
         (key, cfg.sigma, cfg.sigma, m)),
        (pricing._vega_sums_fn(cfg, engine, None),
         (key, cfg.sigma, cfg.sigma, m)),
    ]
    highest = jax.lax.Precision.HIGHEST
    for fn, args in fns:
        precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
        assert precs, fn
        assert all(p == (highest, highest) for p in precs), precs
