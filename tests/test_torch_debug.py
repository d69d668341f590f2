"""The port's numeric and shard-consistency checks
(``modem_tpu_torch.debug``) against the JAX package's ``modem_tpu.debug``
on the same numpy inputs: ``finite_fraction`` and ``assert_finite`` in this
process, ``halo_mismatch`` on 4 gloo ranks (the harness of
``tests/test_torch_parallel.py``: this file run as a script is the worker)
against the JAX function on the conftest's virtual CPU devices. Values
equal: the fractions and the mismatches are exact.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from test_torch_parallel import (MESHES, ROOT, WORLD, _Inputs,  # noqa: E402
                                 jmesh, join_world, results, run_worker,
                                 start_world)

HALO, N_LOCAL = 4, 16


def overlapped(ranks: int, corrupt: bool, channels: int | None = None):
    """A stream cut into ``ranks`` blocks of ``N_LOCAL`` that overlap by
    ``HALO``: block t's first ``HALO`` samples are block t-1's last. With
    ``corrupt``, the first sample of block ``ranks // 2`` is one off."""
    base = np.arange(ranks * (N_LOCAL - HALO) + HALO, dtype=np.float32)
    x = np.concatenate([base[t * (N_LOCAL - HALO): t * (N_LOCAL - HALO)
                             + N_LOCAL] for t in range(ranks)])
    if corrupt:
        x[(ranks // 2) * N_LOCAL] += 1.0
    if channels:
        x = np.stack([x + 100.0 * c for c in range(channels)])
    return x


def _halo_case(key, dims, batch):
    def run(mesh, inp):
        from modem_tpu_torch.debug import halo_mismatch
        from modem_tpu_torch.parallel.mesh import shard_block

        x = shard_block(inp[key], mesh, dims)
        return {"diff": ("r", halo_mismatch(x, mesh, HALO,
                                            batch_axis=batch))}
    return run


CASES = {
    "exact_1d": ("14", _halo_case("exact_1d", ("time",), None), None),
    "corrupt_1d": ("14", _halo_case("corrupt_1d", ("time",), None), None),
    "exact_2d": ("22", _halo_case("exact_2d", ("ch", "time"), "ch"), None),
    "corrupt_2d": ("22", _halo_case("corrupt_2d", ("ch", "time"), "ch"),
                   None),
}


def make_data() -> dict:
    return {"exact_1d": overlapped(4, False),
            "corrupt_1d": overlapped(4, True),
            "exact_2d": overlapped(2, False, channels=2),
            "corrupt_2d": overlapped(2, True, channels=2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp

    from modem_tpu.debug import halo_mismatch

    tmp = tmp_path_factory.mktemp("debug")
    data = make_data()
    npz = tmp / "inputs.npz"
    np.savez(npz, **data)
    w4 = start_world(HERE, npz, tmp / "w4", WORLD)
    refs = {}
    for name, (mesh_key, _, _) in CASES.items():
        batch = "ch" if name.endswith("2d") else None
        refs[name] = float(halo_mismatch(jnp.asarray(data[name]),
                                         jmesh(mesh_key), HALO,
                                         batch_axis=batch))
    return {"refs": refs, "w4": join_world(w4, tmp / "w4", WORLD)}


@pytest.mark.parametrize("name", list(CASES))
def test_halo_mismatch_equals_jax(runs, name):
    got = float(results(runs["w4"], name, MESHES[CASES[name][0]])["diff"])
    assert got == runs["refs"][name]
    assert got == (0.0 if name.startswith("exact") else 1.0)


def _trees():
    ok = {"a": np.ones((4,), np.float32), "b": np.zeros((2, 2), np.float32)}
    bad = {"a": np.asarray([1.0, np.nan, np.inf, 0.0], np.float32)}
    mixed = ([np.asarray([1.0, np.nan], np.float32)],
             {"n": np.arange(3, dtype=np.int32),
              "f": (np.full((3,), 2.0, np.float32),)})
    ints = {"ints": np.arange(3, dtype=np.int32)}
    return {"ok": ok, "bad": bad, "mixed": mixed, "ints": ints}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("name", list(_trees()))
def test_finite_fraction_equals_jax(name):
    import jax.numpy as jnp

    from modem_tpu.debug import finite_fraction as jff
    from modem_tpu_torch.debug import finite_fraction

    tree = _trees()[name]
    got = finite_fraction(_map(tree, torch.as_tensor))
    want = jff(_map(tree, jnp.asarray))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


@pytest.mark.parametrize("name", list(_trees()))
def test_assert_finite_raises_as_jax(name):
    import jax.numpy as jnp

    from modem_tpu.debug import assert_finite as jaf
    from modem_tpu_torch.debug import assert_finite

    tree = _trees()[name]
    outcomes = []
    for fn, conv in ((assert_finite, torch.as_tensor),
                     (jaf, jnp.asarray)):
        try:
            fn(_map(tree, conv), name)
            outcomes.append(None)
        except FloatingPointError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_ranks_load_no_jax(runs):
    assert not any(bool(r["jax_loaded|flag|r"]) for r in runs["w4"])


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    run_worker(CASES, _Inputs(sys.argv[1]), sys.argv[2],
               *map(int, sys.argv[3:6]))
