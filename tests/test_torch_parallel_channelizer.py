"""The port's channel-sharded receivers and distributed front end
(``modem_tpu_torch.parallel``: ``acquire``, ``ofdm``, ``channelizer``) and
the meshed ``WidebandModem``, against the JAX package on the same numpy
inputs.

As ``tests/test_torch_parallel.py`` (whose harness this file shares): this
file run as a script is the worker, one module fixture runs a world of 4
gloo ranks on the CPU and a world of one, the parent assembles the ranks'
blocks and holds them against the JAX sharded functions on the conftest's
virtual CPU devices. The re-deal is also held at an uneven ``M/D`` (12
channels over 4 ranks, 3 a rank).

Tolerances: decisions and payload bits equal; the banks' and the
``WidebandModem``'s waveforms within 2e-5 absolute plus 2e-5 relative (the
bar of ``tests/test_torch_wideband.py``); the OFDM frame within 1e-5
absolute (the bar of ``tests/test_torch_ofdm.py``). On the world of one
every sharded call equals the single-device port's bit for bit.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from test_torch_parallel import (MESHES, ROOT, WORLD, _Inputs, _bits,  # noqa: E402
                                 _scheme, jmesh, join_world, results,
                                 run_worker, start_world)

PRE = np.array([0, 1, 3, 2, 2, 0, 1, 1, 3, 0, 2, 3, 0, 0, 1, 2,
                3, 3, 1, 0, 2, 1, 0, 2, 1, 3, 2, 2, 0, 3, 1, 0])
M, N_PAY = 16, 96
M_ODD = 12
N_OFDM = 8
TOL = 2e-5


def make_data() -> dict:
    rng = np.random.default_rng(0)
    n = WORLD * M * 64
    return {
        "wb_wi": rng.normal(size=n).astype(np.float32),
        "wb_wq": rng.normal(size=n).astype(np.float32),
        "ch_ci": rng.normal(size=(M, WORLD * 64)).astype(np.float32),
        "ch_cq": rng.normal(size=(M, WORLD * 64)).astype(np.float32),
        "odd_ci": rng.normal(size=(M_ODD, WORLD * 48)).astype(np.float32),
        "odd_cq": rng.normal(size=(M_ODD, WORLD * 48)).astype(np.float32),
        "story_bits": _bits((M, N_PAY * 2), 3),
        "acq_bits": _bits((8, 128), 21),
        "wm_bits": _bits((M, N_PAY * 2), 5),
    }


# --------------------------------------------------------------------------
# the worker's cases (torch, numpy and the port only)
# --------------------------------------------------------------------------

class _ChInputs(_Inputs):
    def rxr(self, **kw):
        from modem_tpu_torch import AcquiringReceiver

        return AcquiringReceiver(self.chain("qpsk"), PRE, **kw)

    def bank(self, m=M):
        from modem_tpu_torch import Channelizer

        return Channelizer(m, device="cpu")

    def ofdm(self):
        from modem_tpu_torch import OfdmModem

        return OfdmModem(_scheme("qpsk"), device="cpu")


def _block(x, mesh, dims):
    from modem_tpu_torch.parallel.mesh import shard_block

    return shard_block(x, mesh, dims)


def _case_analyze(mesh, inp):
    from modem_tpu_torch.parallel import sharded_analyze_fn

    yi, yq = sharded_analyze_fn(inp.bank(), mesh)(
        _block(inp["wb_wi"], mesh, ("time",)),
        _block(inp["wb_wq"], mesh, ("time",)))
    return {"yi": ("t", yi), "yq": ("t", yq)}


def _single_analyze(inp):
    yi, yq = inp.bank().analyze(inp["wb_wi"], inp["wb_wq"])
    return {"yi": yi, "yq": yq}


def _case_synthesize(mesh, inp):
    from modem_tpu_torch.parallel import sharded_synthesize_fn

    wi, wq = sharded_synthesize_fn(inp.bank(), mesh)(
        _block(inp["ch_ci"], mesh, (None, "time")),
        _block(inp["ch_cq"], mesh, (None, "time")))
    return {"wi": ("t", wi), "wq": ("t", wq)}


def _single_synthesize(inp):
    wi, wq = inp.bank().synthesize(inp["ch_ci"], inp["ch_cq"])
    return {"wi": wi, "wq": wq}


def _redeal(m, prefix):
    def run(mesh, inp):
        from modem_tpu_torch.parallel import wideband_rx_fn, wideband_tx_fn

        bank = inp.bank(m)
        ci = _block(inp[f"{prefix}_ci"], mesh, ("time",))
        cq = _block(inp[f"{prefix}_cq"], mesh, ("time",))
        wi, wq = wideband_tx_fn(bank, mesh)(ci, cq)
        yi, yq = wideband_rx_fn(bank, mesh)(wi, wq)
        return {"wi": ("t", wi), "wq": ("t", wq), "yi": ("t0", yi),
                "yq": ("t0", yq)}

    def single(inp):
        bank = inp.bank(m)
        wi, wq = bank.synthesize(inp[f"{prefix}_ci"], inp[f"{prefix}_cq"])
        yi, yq = bank.analyze(wi, wq)
        return {"wi": wi, "wq": wq, "yi": yi, "yq": yq}

    return run, single


def _story_channels(inp, rxr, bits):
    ci, cq = rxr.tx_burst(bits)
    pad = torch.zeros(ci.shape[:-1] + ((-ci.shape[-1] - 256) % 8 + 256,))
    return torch.cat([ci, pad], -1), torch.cat([cq, pad], -1)


def _case_story(mesh, inp):
    from modem_tpu_torch.parallel import wideband_rx_fn, wideband_tx_fn

    rxr, bank = inp.rxr(max_lag=200), inp.bank()
    ci, cq = _story_channels(inp, rxr,
                             _block(inp["story_bits"], mesh, ("time",)))
    wi, wq = wideband_tx_fn(bank, mesh)(ci, cq)
    yi, yq = wideband_rx_fn(bank, mesh)(wi, wq)
    return {"bits": ("t0", rxr.rx(yi, yq, N_PAY))}


def _single_story(inp):
    rxr, bank = inp.rxr(max_lag=200), inp.bank()
    ci, cq = _story_channels(inp, rxr, inp["story_bits"])
    yi, yq = bank.analyze(*bank.synthesize(ci, cq))
    return {"bits": rxr.rx(yi, yq, N_PAY)}


def _acq_rxr(inp):
    return inp.rxr(max_lag=128, eq_taps=5, track_block=16)


def _case_acquire(mesh, inp):
    from modem_tpu_torch.parallel import sharded_acquire_fn

    fn = sharded_acquire_fn(_acq_rxr(inp), mesh, 64)
    return {"bits": ("c", fn(_block(inp["acq_i"], mesh, ("ch",)),
                             _block(inp["acq_q"], mesh, ("ch",))))}


def _single_acquire(inp):
    return {"bits": _acq_rxr(inp).rx(inp["acq_i"], inp["acq_q"], 64)}


def _case_ofdm(mesh, inp):
    from modem_tpu_torch.parallel import sharded_ofdm_rx_fn, sharded_ofdm_tx_fn

    m = inp.ofdm()
    i, q = sharded_ofdm_tx_fn(m, mesh)(_block(inp["ofdm_bits"], mesh,
                                              ("ch",)))
    blind = sharded_ofdm_rx_fn(m, mesh, N_OFDM, max_lag=64)(
        _block(inp["ofdm_ci"], mesh, ("ch",)),
        _block(inp["ofdm_cq"], mesh, ("ch",)))
    aligned = sharded_ofdm_rx_fn(m, mesh, N_OFDM)(i, q)
    return {"i": ("c", i), "q": ("c", q), "blind": ("c", blind),
            "aligned": ("c", aligned)}


def _single_ofdm(inp):
    m = inp.ofdm()
    i, q = m.tx_frame(inp["ofdm_bits"])
    blind, _ = m.acquire(inp["ofdm_ci"], inp["ofdm_cq"], N_OFDM, 64)
    return {"i": i, "q": q, "blind": blind,
            "aligned": m.rx_frame(i, q, N_OFDM)}


def _case_wideband(mesh, inp):
    from modem_tpu_torch import WidebandModem

    wm = WidebandModem(inp.rxr(max_lag=200), M, N_PAY, mesh=mesh)
    wi, wq = wm.tx(_block(inp["wm_bits"], mesh, ("time",)))
    return {"wi": ("t", wi), "wq": ("t", wq),
            "bits": ("t0", wm.rx(wi, wq)),
            "window": ("r", torch.tensor(wm.window))}


def _single_wideband(inp):
    from modem_tpu_torch import WidebandModem

    wm = WidebandModem(inp.rxr(max_lag=200), M, N_PAY)
    wi, wq = wm.tx(inp["wm_bits"])
    return {"wi": wi, "wq": wq, "bits": wm.rx(wi, wq),
            "window": torch.tensor(wm.window)}


def _case_wideband_refuses(mesh, inp):
    from modem_tpu_torch import WidebandModem

    refused = []
    for args, kw, err in (((M + 2, N_PAY), {"mesh": mesh}, ValueError),
                          ((M, N_PAY), {"mesh": object()}, TypeError)):
        try:
            WidebandModem(inp.rxr(max_lag=200), *args, **kw)
            refused.append(0)
        except err:
            refused.append(1)
    return {"refused": ("r", torch.tensor(refused))}


CASES = {
    "analyze": ("14", _case_analyze, _single_analyze),
    "synthesize": ("14", _case_synthesize, _single_synthesize),
    "redeal": ("14",) + _redeal(M, "ch"),
    "redeal_uneven": ("14",) + _redeal(M_ODD, "odd"),
    "redeal_2x2": ("22",) + _redeal(M, "ch"),
    "bursts_through_one_stream": ("14", _case_story, _single_story),
    "acquire": ("41", _case_acquire, _single_acquire),
    "ofdm": ("41", _case_ofdm, _single_ofdm),
    "wideband_modem": ("14", _case_wideband, _single_wideband),
    "wideband_modem_refuses": ("14", _case_wideband_refuses, None),
}


# --------------------------------------------------------------------------
# the parent: JAX inputs and references
# --------------------------------------------------------------------------

def jax_inputs(data: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from modem_tpu import qpsk_reference_chain
    from modem_tpu.config import Rates as JRates
    from modem_tpu.models import make_scheme
    from modem_tpu.ofdm import OfdmModem
    from modem_tpu.ops.channel import awgn
    from modem_tpu.ops.impairments import (apply_cfo, apply_gain_phase,
                                           apply_static_delay, multipath_fir)
    from modem_tpu.sync import AcquiringReceiver

    jr = JRates(1250, 10000)
    d = dict(data)
    chain = qpsk_reference_chain(jr)
    d["qpsk_lut"], d["qpsk_rrc"] = np.asarray(chain.lut), np.asarray(chain.rrc)
    d["qpsk_bps"] = np.int32(2)
    rxr = AcquiringReceiver(chain, PRE, max_lag=128, eq_taps=5,
                            track_block=16)
    i, q = rxr.tx_burst(jnp.asarray(d["acq_bits"]))
    i, q = apply_static_delay(i, q, 0.4)
    i, q = apply_cfo(i, q, 6.0, 10000, phase0=0.3)
    i, q = awgn(jax.random.key(4), i, q, snr_db=30.0)
    d["acq_i"], d["acq_q"] = np.asarray(i), np.asarray(q)
    m = OfdmModem(make_scheme("qpsk", jr))
    bits = np.random.default_rng(12).integers(
        0, 2, (8, m.bits_per_frame(N_OFDM))).astype(np.int32)
    d["ofdm_bits"] = bits
    i, q = m.tx_frame(jnp.asarray(bits))
    gap = jnp.zeros(i.shape[:-1] + (21,), i.dtype)
    ci, cq = multipath_fir(jnp.concatenate([gap, i], -1),
                           jnp.concatenate([gap, q], -1),
                           np.array([1.0, 0.0, 0.15, 0.0, -0.05], np.float32),
                           np.array([0.0, 0.1, 0.0, 0.05, 0.0], np.float32))
    ci, cq = apply_cfo(ci, cq, cfo_hz=0.7 / 64.0, sample_rate=1)
    ci, cq = apply_gain_phase(ci, cq, gain=1.4, phase=-2.0)
    ci, cq = awgn(jax.random.PRNGKey(5), ci, cq, 25.0)
    d["ofdm_ci"], d["ofdm_cq"] = np.asarray(ci), np.asarray(cq)
    return d


def jax_refs(d: dict) -> dict:
    import jax.numpy as jnp

    from modem_tpu import qpsk_reference_chain
    from modem_tpu import parallel as jp
    from modem_tpu.config import Rates as JRates
    from modem_tpu.models import make_scheme
    from modem_tpu.ofdm import OfdmModem
    from modem_tpu.ops.channelizer import Channelizer
    from modem_tpu.sync import AcquiringReceiver
    from modem_tpu.wideband import WidebandModem

    jr = JRates(1250, 10000)
    m14, m22, m41 = jmesh("14"), jmesh("22"), jmesh("41")
    a = {k: jnp.asarray(v) for k, v in d.items()}
    bank = Channelizer(M)
    j = {}
    yi, yq = jp.sharded_analyze_fn(bank, m14)(a["wb_wi"], a["wb_wq"])
    j["analyze"] = {"yi": yi, "yq": yq}
    wi, wq = jp.sharded_synthesize_fn(bank, m14)(a["ch_ci"], a["ch_cq"])
    j["synthesize"] = {"wi": wi, "wq": wq}
    for case, m, prefix, mesh in (("redeal", M, "ch", m14),
                                  ("redeal_uneven", M_ODD, "odd", m14),
                                  ("redeal_2x2", M, "ch", m22)):
        b = Channelizer(m)
        wi, wq = jp.wideband_tx_fn(b, mesh)(a[f"{prefix}_ci"],
                                            a[f"{prefix}_cq"])
        yi, yq = jp.wideband_rx_fn(b, mesh)(wi, wq)
        j[case] = {"wi": wi, "wq": wq, "yi": yi, "yq": yq}
    rxr = AcquiringReceiver(qpsk_reference_chain(jr), PRE, max_lag=200)
    ci, cq = rxr.tx_burst(a["story_bits"])
    pad = jnp.zeros((M, (-ci.shape[-1] - 256) % 8 + 256), ci.dtype)
    ci, cq = (jnp.concatenate([ci, pad], -1), jnp.concatenate([cq, pad], -1))
    wi, wq = jp.wideband_tx_fn(bank, m14)(ci, cq)
    yi, yq = jp.wideband_rx_fn(bank, m14)(wi, wq)
    j["bursts_through_one_stream"] = {"bits": rxr.rx(yi, yq, N_PAY)}
    arxr = AcquiringReceiver(qpsk_reference_chain(jr), PRE, max_lag=128,
                             eq_taps=5, track_block=16)
    j["acquire"] = {"bits": jp.sharded_acquire_fn(arxr, m41, 64)(
        a["acq_i"], a["acq_q"])}
    om = OfdmModem(make_scheme("qpsk", jr))
    i, q = jp.sharded_ofdm_tx_fn(om, m41)(a["ofdm_bits"])
    j["ofdm"] = {"i": i, "q": q,
                 "blind": jp.sharded_ofdm_rx_fn(om, m41, N_OFDM, max_lag=64)(
                     a["ofdm_ci"], a["ofdm_cq"]),
                 "aligned": jp.sharded_ofdm_rx_fn(om, m41, N_OFDM)(i, q)}
    wm = WidebandModem(rxr, M, N_PAY, mesh=m14)
    wi, wq = wm.tx(a["wm_bits"])
    j["wideband_modem"] = {"wi": wi, "wq": wq, "bits": wm.rx(wi, wq),
                           "window": np.asarray(wm.window)}
    j["wideband_modem_refuses"] = {"refused": np.asarray([1, 1])}
    return {c: {k: np.asarray(v) for k, v in vals.items()}
            for c, vals in j.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_channelizer")
    data = jax_inputs(make_data())
    npz = tmp / "inputs.npz"
    np.savez(npz, **data)
    w4 = start_world(HERE, npz, tmp / "w4", WORLD)
    w1 = start_world(HERE, npz, tmp / "w1", 1)
    refs = jax_refs(data)
    return {"data": data, "refs": refs,
            "w4": join_world(w4, tmp / "w4", WORLD),
            "w1": join_world(w1, tmp / "w1", 1)}


def _hold(name, key, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, key, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
        assert np.array_equal(got, want), (name, key)
    else:
        tol = 1e-5 if name == "ofdm" else TOL
        np.testing.assert_allclose(got, want, rtol=0 if name == "ofdm"
                                   else TOL, atol=tol,
                                   err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_equal_jax(runs, name):
    """The blocks of 4 gloo ranks, assembled, against the JAX sharded
    function on the same inputs and mesh shape."""
    got = results(runs["w4"], name, MESHES[CASES[name][0]])
    want = runs["refs"][name]
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        _hold(name, key, got[key], want[key])


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[2] is not None])
def test_world_of_one_equals_single_device(runs, name):
    """On a 1x1 mesh each sharded call equals the single-device port's,
    bit for bit."""
    ranks = runs["w1"]
    got = results(ranks, name, (1, 1))
    singles = {k.split("|")[1]: v for k, v in ranks[0].items()
               if k.startswith(f"{name}|") and k.endswith("|single")}
    assert singles
    for key, want in singles.items():
        g = np.asarray(got[key])
        assert g.shape == want.shape, (key, g.shape, want.shape)
        assert np.array_equal(g, want), key


def test_every_payload_bit_arrives(runs):
    """The bursts, the acquisition, OFDM and the meshed modem deliver every
    payload bit on the 4 ranks."""
    d = runs["data"]
    for name, key, bits in (("bursts_through_one_stream", "bits",
                             "story_bits"), ("acquire", "bits", "acq_bits"),
                            ("ofdm", "blind", "ofdm_bits"),
                            ("ofdm", "aligned", "ofdm_bits"),
                            ("wideband_modem", "bits", "wm_bits")):
        got = results(runs["w4"], name, MESHES[CASES[name][0]])[key]
        want = d[bits][..., :got.shape[-1]] if name == "acquire" else d[bits]
        assert np.array_equal(got, want), name


def test_ranks_load_no_jax(runs):
    for world in ("w4", "w1"):
        assert not any(bool(r["jax_loaded|flag|r"]) for r in runs[world])


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    run_worker(CASES, _ChInputs(sys.argv[1]), sys.argv[2],
               *map(int, sys.argv[3:6]))
