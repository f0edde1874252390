"""The wall-clock timer (utils/timing.bench): warmup calls are not timed,
every timed call ends in jax.block_until_ready, and the reading is the
median of the timed calls.  A fake clock makes the checks exact."""

import numpy as np
import pytest

from hullwhite_tpu.utils import timing


class _FakeClock:
    """Advances only when the fake kernel runs: call i takes costs[i]."""

    def __init__(self, costs):
        self.costs = list(costs)
        self.now = 0.0
        self.calls = 0

    def __call__(self):
        return self.now

    def kernel(self):
        self.now += self.costs[self.calls]
        self.calls += 1
        return np.full(4, self.calls)


def test_bench_excludes_warmup_and_returns_median():
    clock = _FakeClock([50.0, 5.0, 1.0, 2.0, 3.0, 4.0])
    dt, out = timing.bench(clock.kernel, n=5, warmup=1, clock=clock)
    assert dt == 3.0                       # median of 5, 1, 2, 3, 4
    assert clock.calls == 6
    assert out[0] == 6                     # the last call's result


def test_stall_in_measurement_window_rejected():
    """One stalled call among n does not move the median."""
    costs = [1e-3] * 11
    costs[5] = 0.15
    clock = _FakeClock(costs)
    dt, _ = timing.bench(clock.kernel, n=10, warmup=1, clock=clock)
    assert dt == pytest.approx(1e-3)


def test_bench_blocks_on_every_call(monkeypatch):
    blocked = []
    monkeypatch.setattr(timing.jax, "block_until_ready",
                        lambda x: blocked.append(x) or x)
    clock = _FakeClock([1.0] * 7)
    timing.bench(clock.kernel, n=4, warmup=3, clock=clock)
    assert len(blocked) == 7               # warmups and timed calls alike


@pytest.mark.parametrize("warmup", [0, 2])
def test_bench_warmup_count(warmup):
    clock = _FakeClock([1.0] * (warmup + 3))
    timing.bench(clock.kernel, n=3, warmup=warmup, clock=clock)
    assert clock.calls == warmup + 3


def test_bench_rejects_no_timed_calls():
    with pytest.raises(ValueError):
        timing.bench(lambda: 0, n=0)


def test_bench_passes_arguments_and_times_a_jitted_fn():
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x, y: x * y)
    dt, out = timing.bench(f, jnp.arange(4.0), 2.0, n=3)
    assert dt > 0
    np.testing.assert_array_equal(np.asarray(out), [0.0, 2.0, 4.0, 6.0])
