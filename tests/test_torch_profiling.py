"""The port's timing helpers (``modem_tpu_torch.profiling``) on the CPU. The
cases mirror ``tests/test_aux.py``'s ``TestMeasure``; the arithmetic that
turns pass times into a measurement (best pass, spread, median, the
marginal slope and floor, the summaries) is held equal to the JAX
package's on the same pass times. Times themselves are not compared."""

import json
import os

import pytest
import torch

import jax.numpy as jnp

from modem_tpu import profiling as jprof

from modem_tpu_torch import profiling as tprof

torch.set_num_threads(1)


class TestMeasure:
    def test_measure_runs(self):
        x = torch.ones((4, 8, 128))
        m = tprof.measure(lambda b: b * 2.0, (x,), samples_per_call=8 * 128)
        assert m.seconds_per_call > 0
        assert m.samples_per_s > 0
        assert len(m.all_seconds) == 5
        assert m.seconds_per_call == min(m.all_seconds)
        assert "Gsamp/s" in m.summary()

    def test_measure_sees_each_rep(self):
        # every rep gets its own slice, and nothing is called more than a
        # pass's reps + the absorbed pass's
        seen = []
        x = torch.arange(3.0).reshape(3, 1)
        tprof.measure(lambda b: seen.append(float(b)) or b, (x,), 1, passes=2)
        assert seen == [0.0, 1.0, 2.0] * 3

    def test_measure_marginal(self):
        # slope between two rep scales cancels any fixed per-pass floor
        xs = torch.ones((2, 64, 512))
        xl = torch.ones((16, 64, 512))
        w = torch.ones((512, 512))
        mm = tprof.measure_marginal(lambda b: torch.tanh(b) @ w, (xs,),
                                    (xl,), samples_per_call=64 * 512)
        assert mm.marginal_samples_per_s > 0
        assert mm.floor_seconds >= 0.0
        assert "marginal" in mm.summary()
        with pytest.raises(ValueError):
            tprof.measure_marginal(lambda b: b, (xl,), (xs,), 1)


PASSES = [(2e-3, 2.4e-3, 1.9e-3, 2.2e-3, 2.05e-3),
          (7e-4,),
          (1.1e-3, 1.0e-3)]


@pytest.mark.parametrize("times", PASSES)
@pytest.mark.parametrize("rates", [(None, None), (3e9, 1.2e8)])
def test_measurement_equals_the_jax_package(times, rates):
    best = min(times)
    kw = dict(seconds_per_call=best, samples_per_s=4096 / best,
              flops_per_s=None if rates[0] is None else rates[0] / best,
              bytes_per_s=None if rates[1] is None else rates[1] / best,
              all_seconds=times)
    j, t = jprof.Measurement(**kw), tprof.Measurement(**kw)
    assert t.spread == j.spread
    assert t.median_seconds_per_call == j.median_seconds_per_call
    assert t.summary() == j.summary()


@pytest.mark.parametrize("small,large", [((2, 3e-3), (16, 1.2e-3)),
                                         ((4, 1e-3), (8, 9e-4))])
def test_marginal_arithmetic_equals_the_jax_package(monkeypatch, small,
                                                    large):
    """``measure_marginal`` on the same per-scale measurements: the same
    slope, floor and summary as the JAX package's."""
    def fake(mod):
        def measure(fn, args, samples_per_call, passes=5):
            per = {small[0]: small[1], large[0]: large[1]}[args[0].shape[0]]
            return mod.Measurement(per, samples_per_call / per, None, None,
                                   (per, 1.1 * per))
        return measure

    monkeypatch.setattr(jprof, "measure", fake(jprof))
    monkeypatch.setattr(tprof, "measure", fake(tprof))
    js = jprof.measure_marginal(None, (jnp.zeros((small[0], 1)),),
                                (jnp.zeros((large[0], 1)),), 1000)
    ts = tprof.measure_marginal(None, (torch.zeros((small[0], 1)),),
                                (torch.zeros((large[0], 1)),), 1000)
    assert ts.marginal_samples_per_s == js.marginal_samples_per_s
    assert ts.floor_seconds == js.floor_seconds
    assert ts.summary() == js.summary()


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")):
        y = torch.ones(64).cumsum(0)
    assert float(y[-1]) == 64.0
    path = tmp_path / "t" / "trace.json"
    assert os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
