"""The port's multi-device layer (``modem_tpu_torch.parallel``: the mesh,
bootstrap, collectives, channel sharding, the sharded FIR, pulse and
differential chains, modulator, demodulator, FSK loopback, resampled chain
and Viterbi decoder) and ``LinkStats.psum``, against the JAX package on the
same numpy inputs.

The port's ranks are real processes: this file run as a script is the
worker (it imports torch, numpy and the port only). One module fixture
starts a world of 4 gloo ranks on the CPU (meshes 2x2, 1x4 and 4x1) and a
world of one (every mesh 1x1), each rank running every case on its own
block; the parent assembles the blocks. The JAX side runs here on the
conftest's virtual CPU devices (``make_modem_mesh(..., devices=
jax.devices()[:4])``), its Pallas kernels as the JAX tests run them on the
CPU. Inputs are made with numpy from a seed and reach the ranks through an
``.npz``.

Tolerances: decisions and decoded bits equal; FIR, TX and demodulator
waveforms ``atol=1e-5`` (the single-device parity tests' bar for f32
reassociation), the sharded FIR's other backends ``1e-4`` on its
unnormalised taps (``tests/test_fir.py``'s bar for the backends), K11's
``1e-6``, the FSK-family baseband ``1e-6`` and DMPSK ``2e-5``
(``tests/test_parallel.py``'s bar for f32 rotation); the fused noisy BER's
error count within ``max(2, 0.1%)`` of JAX's at the same seed
(the single-device ``fused_ber_point`` bar), the noisy FSK decisions on at
least 99.9% of symbols (the single-device K6 bar); the staged noisy paths
draw from torch generators, so they are held to errors present at low SNR
and none at 20 dB. On the world of one every sharded call equals the
single-device port's bit for bit (the staged noisy paths, which have no
single-device form, excepted; the demodulator's fft backend within 1e-6).
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[1]
WORLD = 4
MESHES = {"22": (2, 2), "14": (1, 4), "41": (4, 1)}
SR, BAUD, CARRIER = 10000, 1250, 2000
SCHEMES = ["qpsk", "bpsk", "bfsk", "mfsk", "dqpsk", "dbpsk", "dcqpsk",
           "msk", "oqpsk", "16cpfsk", "qam16", "16apsk"]
FSK_SNR_DB = 18.0
BER_SNR_DB = 7.0
SEED = 5
#: the FIR engine's backends beside ``direct``, each on the sharded FIR,
#: the staged flagship and the demodulator
FIR_BACKENDS = ("conv", "matmul", "fft")


# --------------------------------------------------------------------------
# inputs: numpy, from a seed
# --------------------------------------------------------------------------

def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32)


def make_data() -> dict:
    """Every case's global inputs (the chains' tables come from JAX and are
    added by the parent)."""
    rng = np.random.default_rng(0)
    d = {
        "halo_x": rng.normal(size=(24,)).astype(np.float32),
        "halo_x2": rng.normal(size=(4, 24)).astype(np.float32),
        "fir_x": rng.normal(size=(640,)).astype(np.float32),
        "fir_taps": rng.normal(size=33).astype(np.float32),
        "fir_x2": rng.normal(size=(4, 320)).astype(np.float32),
        "fir_taps2": rng.normal(size=17).astype(np.float32),
        "bits_ch": _bits((8, 128), 30),
        "bits_qpsk": _bits((4, 128), 3),
        "bits_qam": _bits((2, 128), 4),
        "bits_pb": _bits((4, 128), 21),
        "bits_ber": _bits((4, 512), 22),
        "bits_fused": _bits((4, 192), 11),
        "bits_fused_qam": _bits((4, 384), 13),
        "bits_noisy": _bits((4, 512), 7),
        "bits_tx": _bits((4, 192), 21),
        "bits_tx_qam": _bits((4, 384), 23),
        "bits_dq": _bits((4, 192), 31),
        "bits_fsk_mfsk": _bits((4, 512), 9),
        "bits_fsk_bfsk": _bits((4, 128), 9),
        "bits_fsk_1d": _bits((256,), 12),
        "bits_demod": _bits((4, 64), 31),
        "bits_demod1": _bits((64,), 31),
        "lstats_tx": _bits((4, 333), 40),
    }
    d["lstats_rx"] = d["lstats_tx"] ^ (
        np.random.default_rng(41).random((4, 333)) < 0.02).astype(np.int32)
    for name in SCHEMES:
        bps = {"qpsk": 2, "bpsk": 1, "bfsk": 1, "mfsk": 4, "dqpsk": 2,
               "dbpsk": 1, "dcqpsk": 2, "msk": 1, "oqpsk": 2, "16cpfsk": 4,
               "qam16": 4, "16apsk": 4}[name]
        d[f"bits_mod_{name}"] = _bits((64 * bps,), 7)
    d["bits_mod_2d"] = _bits((4, 32 * 4), 8)
    return d


# --------------------------------------------------------------------------
# the worker: one rank, every case (imports torch, numpy and the port only)
# --------------------------------------------------------------------------

def _t(a):
    return torch.as_tensor(np.asarray(a))


class _Inputs:
    """The npz's arrays as CPU tensors, and the port objects built from
    them."""

    def __init__(self, path):
        with np.load(path) as z:
            self.a = {k: z[k] for k in z.files}

    def __getitem__(self, key):
        return _t(self.a[key])

    def chain(self, name):
        from modem_tpu_torch import PulseShapedChain, Rates

        a = self.a
        params = {"lut": a[f"{name}_lut"], "rrc": a[f"{name}_rrc"],
                  "bits_per_symbol": int(a[f"{name}_bps"]), "span": 8,
                  "sps": 8}
        carrier = CARRIER if name.endswith("_pb") else None
        return PulseShapedChain.from_numpy(params, Rates(BAUD, SR),
                                           device="cpu", carrier_hz=carrier)

    def resampled(self, up, down):
        from modem_tpu_torch import ResampledChain, Rates

        p = f"rs{up}{down}"
        a = self.a
        params = {"lut": a[f"{p}_lut"], "rrc": a[f"{p}_rrc"],
                  "taps1": a[f"{p}_taps1"], "taps2": a[f"{p}_taps2"],
                  "bits_per_symbol": 2}
        return ResampledChain.from_numpy(params, Rates(BAUD, SR), up, down,
                                         device="cpu")

    def demod(self, fir_backend="direct"):
        from modem_tpu_torch import Demodulator

        return Demodulator(CARRIER, SR, lowpass=self.a["demod_lowpass"],
                           hilbert=self.a["demod_hilbert"],
                           fir_backend=fir_backend, device="cpu")


def _scheme(name):
    from modem_tpu_torch import Rates, make_scheme

    return make_scheme(name, Rates(BAUD, SR))


def _rates():
    from modem_tpu_torch import Rates

    return Rates(BAUD, SR)


def _rails(prefix, rails, layout="ct"):
    return {f"{prefix}{i}": (layout, r) for i, r in enumerate(rails)}


def _split_tx(wave, n):
    """A single-device TX waveform as the sharded TX's (wave, ext)."""
    waves = (wave,) if torch.is_tensor(wave) else wave
    return (tuple(w[..., :n] for w in waves), tuple(w[..., n:] for w in waves))


# Each case: (mesh of the world of 4, run(mesh, inp) -> {key: (layout,
# local tensor)}, single(inp) -> {key: global tensor} or None). Layouts:
# "ct" blocks over the channel axis 0 and the time axis -1; "t" over time
# (the ranks of channel block 0); "t0" along axis 0 over time (channels
# dealt over the time dimension); "c" over channels (time block 0); "r"
# the same on every rank; "each" every rank's value stacked.

def _case_mesh(mesh, inp):
    from modem_tpu_torch.parallel import make_modem_mesh
    from modem_tpu_torch.parallel.mesh import shard_block

    out = {"coord": ("each", torch.tensor([mesh.get_local_rank("ch"),
                                           mesh.get_local_rank("time")]))}
    world = torch.distributed.get_world_size()
    m = make_modem_mesh(ch=-1, time=world, device_type="cpu")
    out["inferred"] = ("r", torch.tensor(list(m.mesh.shape)))
    try:
        make_modem_mesh(ch=world + 1, time=1, device_type="cpu")
        refused = 0
    except ValueError:
        refused = 1
    out["refused"] = ("r", torch.tensor(refused))
    try:  # no device type: the card, which this machine lacks
        make_modem_mesh(ch=-1, time=world)
        refused = 0
    except RuntimeError:
        refused = int(not torch.cuda.is_available())
    out["cuda_default"] = ("r", torch.tensor(refused))
    out["block"] = ("ct", shard_block(inp["halo_x2"], mesh, ("ch", "time")))
    return out


def _single_mesh(inp):
    return {"block": inp["halo_x2"]}


def _case_halos(mesh, inp):
    from modem_tpu_torch.parallel import (exclusive_prefix, left_halo,
                                          right_halo)
    from modem_tpu_torch.parallel.collectives import psum
    from modem_tpu_torch.parallel.mesh import shard_block

    g = mesh.get_group("time")
    x = shard_block(inp["halo_x"], mesh, ("time",))
    t = mesh.get_local_rank("time")
    v = torch.tensor([t + 1, 3 * t + 2], dtype=torch.int32)
    return {"left": ("t", left_halo(x, 2, g)),
            "right": ("t", right_halo(x, 3, g)),
            "prefix": ("t", exclusive_prefix(v, g)),
            "psum": ("r", psum(v, g))}


def _single_halos(inp):
    v = torch.tensor([1, 2], dtype=torch.int32)
    return {"left": torch.zeros(2), "right": torch.zeros(3),
            "prefix": torch.zeros(2, dtype=torch.int32), "psum": v}


def _case_halos_2d(mesh, inp):
    from modem_tpu_torch.parallel import left_halo, right_halo

    g = mesh.get_group("time")
    x = mesh_block(inp["halo_x2"], mesh)
    return {"left": ("ct", left_halo(x, 2, g)),
            "right": ("ct", right_halo(x, 3, g))}


def _single_halos_2d(inp):
    return {"left": torch.zeros(4, 2), "right": torch.zeros(4, 3)}


def mesh_block(x, mesh):
    from modem_tpu_torch.parallel.mesh import shard_block

    return shard_block(x, mesh, ("ch", "time"))


def _case_channel(mesh, inp):
    from modem_tpu_torch.parallel import channel_sharded
    from modem_tpu_torch.parallel.mesh import shard_block

    chain = inp.chain("qpsk")
    bits = shard_block(inp["bits_ch"], mesh, ("ch",))
    return {"bits": ("c", channel_sharded(chain.roundtrip, mesh)(bits))}


def _single_channel(inp):
    return {"bits": inp.chain("qpsk").roundtrip(inp["bits_ch"])}


def _fir(backend="direct"):
    def run(mesh, inp):
        from modem_tpu_torch.parallel import sharded_fir
        from modem_tpu_torch.parallel.mesh import shard_block

        x = shard_block(inp["fir_x"], mesh, ("time",))
        return {"y": ("t", sharded_fir(x, inp["fir_taps"], mesh,
                                       backend=backend, batch_axis=None))}

    def single(inp):
        from modem_tpu_torch.ops.fir import fir_filter

        return {"y": fir_filter(inp["fir_x"], inp["fir_taps"],
                                backend=backend)[0]}

    return run, single


def _case_fir_2d(mesh, inp):
    from modem_tpu_torch.parallel import sharded_fir

    return {"y": ("ct", sharded_fir(mesh_block(inp["fir_x2"], mesh),
                                    inp["fir_taps2"], mesh))}


def _single_fir_2d(inp):
    from modem_tpu_torch.ops.fir import fir_filter

    return {"y": fir_filter(inp["fir_x2"], inp["fir_taps2"])[0]}


def _staged(name, key, fir_backend=None):
    def chain(inp):
        from modem_tpu_torch import qpsk_reference_chain

        if fir_backend is None:
            return inp.chain(name)
        return qpsk_reference_chain(_rates(), fir_backend=fir_backend,
                                    device="cpu")

    def run(mesh, inp):
        from modem_tpu_torch.parallel import ShardedPulseChain

        sc = ShardedPulseChain(chain(inp), mesh)
        return {"bits": ("ct", sc.roundtrip_fn()(sc.shard_bits(inp[key]),
                                                 0))}

    def single(inp):
        return {"bits": chain(inp).roundtrip(inp[key])}

    return run, single


def _ber(name, key, snr):
    def run(mesh, inp):
        from modem_tpu_torch.parallel import ShardedPulseChain

        sc = ShardedPulseChain(inp.chain(name), mesh)
        err, tot = sc.ber_fn(snr)(sc.shard_bits(inp[key]), SEED)
        return {"err": ("r", err), "tot": ("r", tot)}

    return run, None


def _fused(name, key):
    def run(mesh, inp):
        from modem_tpu_torch.parallel import ShardedPulseChain

        sc = ShardedPulseChain(inp.chain(name), mesh)
        return {"bits": ("ct", sc.fused_roundtrip_fn()(
            sc.shard_bits(inp[key]), 0))}

    def single(inp):
        return {"bits": inp.chain(name).roundtrip_fused(inp[key])}

    return run, single


def _case_fused_ber(mesh, inp):
    from modem_tpu_torch.parallel import ShardedPulseChain

    sc = ShardedPulseChain(inp.chain("qpsk"), mesh)
    err, tot = sc.fused_ber_fn(BER_SNR_DB)(sc.shard_bits(inp["bits_noisy"]),
                                           SEED)
    return {"err": ("r", err), "tot": ("r", tot)}


def _single_fused_ber(inp):
    """K1 on the sharded call's layout, a rank's ``[span sentinels |
    symbols | span+1 sentinels]`` (the noise tiles start at the first)."""
    from modem_tpu_torch.ops.chain_kernel import fused_pulse_chain
    from modem_tpu_torch.parallel.chain import device_seed
    from modem_tpu_torch.utils.bits import pack_bits, unpack_symbols

    chain, bits = inp.chain("qpsk"), inp["bits_noisy"]
    syms = pack_bits(bits, 2)
    c = syms.shape[0]
    ext = torch.cat([torch.full((c, 8), -1, dtype=torch.int32), syms,
                     torch.full((c, 9), -1, dtype=torch.int32)], dim=-1)
    dec = fused_pulse_chain(ext, chain.lut, chain.rrc, 8, 8,
                            snr_db=BER_SNR_DB, seed=device_seed(SEED, 0, 0),
                            sym_offset=-8)[..., 8:8 + syms.shape[-1]]
    err = torch.sum(unpack_symbols(dec, 2) != bits).to(torch.int64)
    return {"err": err, "tot": torch.tensor(bits.numel())}


def _txrx(name, key):
    def run(mesh, inp):
        from modem_tpu_torch.parallel import ShardedPulseChain

        sc = ShardedPulseChain(inp.chain(name), mesh)
        wave, ext = sc.fused_tx_fn()(sc.shard_bits(inp[key]))
        out = {**_rails("wave", wave), **_rails("ext", ext)}
        out["bits"] = ("ct", sc.fused_rx_fn()(wave, ext))
        return out

    def single(inp):
        chain, bits = inp.chain(name), inp[key]
        k = bits.shape[-1] // chain.bits_per_symbol
        wave, ext = _split_tx(chain.tx_fused(bits), k * chain.sps)
        full = chain.tx_fused(bits)
        return {**{f"wave{i}": w for i, w in enumerate(wave)},
                **{f"ext{i}": e for i, e in enumerate(ext)},
                "bits": chain.rx_fused(full, k)}

    return run, single


def _case_diff(mesh, inp):
    from modem_tpu_torch import DifferentialChain
    from modem_tpu_torch.parallel import ShardedDifferentialChain

    sd = ShardedDifferentialChain(
        DifferentialChain(_scheme("dqpsk"), _rates(), device="cpu"), mesh)
    return {"bits": ("ct", sd.fused_roundtrip_fn()(
        sd.shard_bits(inp["bits_dq"])))}


def _single_diff(inp):
    from modem_tpu_torch import DifferentialChain

    chain = DifferentialChain(_scheme("dqpsk"), _rates(), device="cpu")
    return {"bits": chain.roundtrip_fused(inp["bits_dq"])}


def _refuses_non_differential(mesh, inp):
    from modem_tpu_torch.parallel import ShardedDifferentialChain

    try:
        ShardedDifferentialChain(inp.chain("qpsk"), mesh)
        refused = 0
    except TypeError:
        refused = 1
    return {"refused": ("r", torch.tensor(refused))}


def _modulator(name, key, two_d=False):
    def run(mesh, inp):
        from modem_tpu_torch import Modulator
        from modem_tpu_torch.parallel import time_sharded_baseband
        from modem_tpu_torch.parallel.mesh import shard_block

        mod = Modulator(_scheme(name), _rates(), device="cpu")
        dims = ("ch", "time") if two_d else ("time",)
        i, q = time_sharded_baseband(mod, shard_block(inp[key], mesh, dims),
                                     mesh)
        lay = "ct" if two_d else "t"
        return {"i": (lay, i), "q": (lay, q)}

    def single(inp):
        from modem_tpu_torch import Modulator

        mod = Modulator(_scheme(name), _rates(), device="cpu")
        bits = inp[key]
        (i, q), _ = mod.baseband(bits, mod.init_state(bits.shape[:-1]))
        return {"i": i, "q": q}

    return run, single


def _demod_wave(inp, key):
    from modem_tpu_torch import Modulator

    mod = Modulator(_scheme("bpsk"), _rates(), carrier_hz=CARRIER,
                    device="cpu")
    bits = inp[key]
    wave, _ = mod.passband(bits, mod.init_state(bits.shape[:-1]))
    return wave


def _demodulator(key, two_d, fir_backend="direct"):
    def run(mesh, inp):
        from modem_tpu_torch.parallel import sharded_demodulate
        from modem_tpu_torch.parallel.mesh import shard_block

        wave = _demod_wave(inp, key)
        dims = ("ch", "time") if two_d else ("time",)
        i, q = sharded_demodulate(inp.demod(fir_backend),
                                  shard_block(wave, mesh, dims), mesh,
                                  ch_axis="ch" if two_d else None)
        lay = "ct" if two_d else "t"
        return {"i": (lay, i), "q": (lay, q)}

    def single(inp):
        from modem_tpu_torch.ops.pll import LOCK_SAMPLES

        wave, demod = _demod_wave(inp, key), inp.demod(fir_backend)
        st = demod.lock_phase(wave[..., :LOCK_SAMPLES],
                              demod.init_state(wave.shape[:-1]))
        (i, q), _ = demod.demodulate(wave[..., LOCK_SAMPLES:], st)
        z = torch.zeros(wave.shape[:-1] + (LOCK_SAMPLES,))
        return {"i": torch.cat([z, i], -1), "q": torch.cat([z, q], -1)}

    return run, single


def _fsk(name, key, snr=None, chunk=None, two_d=True):
    def run(mesh, inp):
        from modem_tpu_torch.parallel import time_sharded_fsk_roundtrip_fn
        from modem_tpu_torch.parallel.mesh import shard_block

        fn = time_sharded_fsk_roundtrip_fn(_scheme(name), _rates(), mesh,
                                           snr_db=snr, chunk_sym=chunk)
        dims = ("ch", "time") if two_d else ("time",)
        return {"bits": ("ct" if two_d else "t",
                         fn(shard_block(inp[key], mesh, dims), SEED))}

    def single(inp):
        from modem_tpu_torch.ops.fsk_kernel import (DEFAULT_CHUNK_SYM,
                                                    fused_fsk_chain)
        from modem_tpu_torch.parallel.chain import device_seed
        from modem_tpu_torch.utils.bits import pack_bits, unpack_symbols

        sch = _scheme(name)
        bps = sch.bits_per_symbol
        dec = fused_fsk_chain(pack_bits(inp[key], bps), sch, _rates(),
                              chunk_sym=chunk or DEFAULT_CHUNK_SYM,
                              snr_db=snr, seed=device_seed(SEED, 0, 0))
        return {"bits": unpack_symbols(dec, bps)}

    return run, single


def _resampled(up, down):
    def run(mesh, inp):
        from modem_tpu_torch.parallel import ShardedResampledChain

        sr = ShardedResampledChain(inp.resampled(up, down), mesh)
        bits = sr.shard_bits(inp[f"bits_rs{up}{down}"])
        wave, drain = sr.fused_tx_fn()(bits)
        return {**_rails("wave", wave), **_rails("drain", drain),
                "bits": ("ct", sr.fused_rx_fn()(wave, drain)),
                "round": ("ct", sr.fused_roundtrip_fn()(bits)),
                "quantum": ("r", torch.tensor(sr.quantum))}

    def single(inp):
        chain = inp.resampled(up, down)
        bits = inp[f"bits_rs{up}{down}"]
        ci, cq = chain.tx_fused(bits)
        n = (bits.shape[-1] // 2) * chain.sps * up // down
        return {"wave0": ci[..., :n], "wave1": cq[..., :n],
                "drain0": ci[..., n:], "drain1": cq[..., n:],
                "bits": chain.rx_fused((ci, cq), bits.shape[-1] // 2),
                "round": chain.roundtrip_fused(bits)}

    return run, single


def _case_rs_misaligned(mesh, inp):
    from modem_tpu_torch.parallel import ShardedResampledChain

    sr = ShardedResampledChain(inp.resampled(2, 3), mesh)
    try:
        sr.fused_roundtrip_fn()(sr.shard_bits(inp["bits_rs_bad"]))
        msg = ""
    except ValueError as e:
        msg = str(e)
    return {"refused": ("r", torch.tensor(int("multiple" in msg)))}


def _viterbi(key, two_d):
    def run(mesh, inp):
        from modem_tpu_torch.fec import ccsds_code
        from modem_tpu_torch.parallel import sharded_viterbi_fn
        from modem_tpu_torch.parallel.mesh import shard_block

        dims = ("ch", "time") if two_d else ("time",)
        fn = sharded_viterbi_fn(ccsds_code(), mesh,
                                batch_axis="ch" if two_d else None)
        return {"bits": ("ct" if two_d else "t",
                         fn(shard_block(inp[key], mesh, dims)))}

    def single(inp):
        from modem_tpu_torch.fec import ccsds_code

        return {"bits": ccsds_code().decode_soft(inp[key])}

    return run, single


def _case_viterbi_windowed(mesh, inp):
    from modem_tpu_torch.fec import ccsds_code
    from modem_tpu_torch.parallel import channel_sharded
    from modem_tpu_torch.parallel.mesh import shard_block

    code = ccsds_code()
    fn = channel_sharded(lambda x: code.decode_soft_windowed(x, 160), mesh)
    return {"bits": ("c", fn(shard_block(inp["vit_win"], mesh, ("ch",))))}


def _single_viterbi_windowed(inp):
    from modem_tpu_torch.fec import ccsds_code

    return {"bits": ccsds_code().decode_soft_windowed(inp["vit_win"], 160)}


def _case_linkstats(mesh, inp):
    from modem_tpu_torch import LinkStats
    from modem_tpu_torch.parallel.mesh import shard_block

    tx = shard_block(inp["lstats_tx"], mesh, ("ch",))
    rx = shard_block(inp["lstats_rx"], mesh, ("ch",))
    st = LinkStats.zero("cpu").update_bits(tx, rx).update_evm(
        tx.float(), rx.float(), tx.float(), tx.float())
    tot = st.psum(mesh.get_group("ch"))
    return {"bit_err": ("r", tot.bit_err), "bit_tot": ("r", tot.bit_tot),
            "blocks": ("r", tot.blocks), "evm_err": ("r", tot.evm_err)}


def _single_linkstats(inp):
    from modem_tpu_torch import LinkStats

    tx, rx = inp["lstats_tx"], inp["lstats_rx"]
    st = LinkStats.zero("cpu").update_bits(tx, rx).update_evm(
        tx.float(), rx.float(), tx.float(), tx.float())
    return {"bit_err": st.bit_err, "bit_tot": st.bit_tot,
            "blocks": st.blocks, "evm_err": st.evm_err}


CASES = {
    "mesh": ("22", _case_mesh, _single_mesh),
    "halos": ("14", _case_halos, _single_halos),
    "halos_2d": ("22", _case_halos_2d, _single_halos_2d),
    "channel_sharded": ("41", _case_channel, _single_channel),
    "fir": ("14",) + _fir(),
    **{f"fir_{b}": ("14",) + _fir(b) for b in FIR_BACKENDS},
    "fir_2d": ("22", _case_fir_2d, _single_fir_2d),
    "staged_qpsk": ("22",) + _staged("qpsk", "bits_qpsk"),
    "staged_qam16": ("22",) + _staged("qam16", "bits_qam"),
    "staged_passband": ("22",) + _staged("qpsk_pb", "bits_pb"),
    **{f"staged_qpsk_{b}": ("22",) + _staged("qpsk", "bits_qpsk", b)
       for b in FIR_BACKENDS},
    "ber_20db": ("22",) + _ber("qpsk", "bits_qpsk", 20.0),
    "ber_low_snr": ("22",) + _ber("qpsk", "bits_ber", -6.0),
    "ber_passband": ("22",) + _ber("qpsk_pb", "bits_ber", -4.0),
    "fused_qpsk": ("22",) + _fused("qpsk", "bits_fused"),
    "fused_passband_qam16": ("22",) + _fused("qam16_pb", "bits_fused_qam"),
    "fused_ber": ("22", _case_fused_ber, _single_fused_ber),
    "fused_txrx": ("22",) + _txrx("qpsk", "bits_tx"),
    "fused_txrx_passband": ("22",) + _txrx("qam16_pb", "bits_tx_qam"),
    "differential": ("22", _case_diff, _single_diff),
    "differential_refuses": ("22", _refuses_non_differential, None),
    **{f"baseband_{n}": ("14",) + _modulator(n, f"bits_mod_{n}")
       for n in SCHEMES},
    "baseband_2d_mfsk": ("22",) + _modulator("mfsk", "bits_mod_2d", True),
    "demodulate": ("14",) + _demodulator("bits_demod1", False),
    "demodulate_2d": ("22",) + _demodulator("bits_demod", True),
    **{f"demodulate_{b}": ("14",) + _demodulator("bits_demod1", False, b)
       for b in FIR_BACKENDS},
    "fsk_mfsk": ("22",) + _fsk("mfsk", "bits_fsk_mfsk"),
    "fsk_bfsk": ("22",) + _fsk("bfsk", "bits_fsk_bfsk"),
    "fsk_mfsk_noisy": ("22",) + _fsk("mfsk", "bits_fsk_mfsk", FSK_SNR_DB),
    "fsk_1d_chunk32": ("14",) + _fsk("bfsk", "bits_fsk_1d", chunk=32,
                                     two_d=False),
    "resampled_3_2": ("22",) + _resampled(3, 2),
    "resampled_2_3": ("22",) + _resampled(2, 3),
    "resampled_misaligned": ("22", _case_rs_misaligned, None),
    "viterbi": ("22",) + _viterbi("vit_llr", True),
    "viterbi_1d": ("14",) + _viterbi("vit_llr1", False),
    "viterbi_windowed": ("41", _case_viterbi_windowed,
                         _single_viterbi_windowed),
    "linkstats_psum": ("41", _case_linkstats, _single_linkstats),
}


def run_worker(cases: dict, inp, out: str, rank: int, world: int,
               port: int) -> None:
    """One rank of a world: every case on its block, the blocks saved to
    ``out/rank<r>.npz`` (and, in a world of one, the single-device port's
    values beside them)."""
    torch.set_num_threads(1)
    from modem_tpu_torch.parallel import make_modem_mesh
    from modem_tpu_torch.parallel.multihost import initialize_multihost

    mesh41 = initialize_multihost(
        ch=-1, time=1, coordinator_address=f"localhost:{port}",
        num_processes=world, process_id=rank, backend="gloo", device="cpu")
    if world == 1:
        meshes = dict.fromkeys(MESHES, mesh41)
    else:
        meshes = {"41": mesh41}
        for key in ("22", "14"):
            meshes[key] = make_modem_mesh(*MESHES[key], device_type="cpu")
    saved = {}
    for name, (mesh_key, run, single) in cases.items():
        try:
            for key, (layout, val) in run(meshes[mesh_key], inp).items():
                saved[f"{name}|{key}|{layout}"] = val.detach().numpy()
            if world == 1 and single is not None:
                for key, val in single(inp).items():
                    saved[f"{name}|{key}|single"] = val.detach().numpy()
        except Exception:  # reported by the parent's test of this case
            saved[f"{name}|error|"] = np.array(traceback.format_exc())
    saved["jax_loaded|flag|r"] = np.array(
        any(m == "jax" or m.startswith(("jax.", "modem_tpu."))
            for m in sys.modules))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------
# the parent: the JAX references, the worlds, the assembly
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(script: pathlib.Path, npz, out, world: int):
    """Start ``world`` ranks of ``script`` as processes (no ``PYTHONPATH``:
    the worker puts the repository on its path)."""
    os.makedirs(out, exist_ok=True)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, str(script), str(npz), str(out), str(r), str(world),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(ROOT)) for r in range(world)]


def join_world(procs, out, world: int) -> list[dict]:
    """Wait for the ranks; their saved blocks, by rank."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log}"
    ranks = []
    for r in range(world):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


def assemble(ranks: list[dict], shape: tuple[int, int], key: str,
             layout: str):
    """The global value of ``key`` (``case|name``) from the ranks'
    blocks."""
    ch, tm = shape
    blk = [ranks[r][f"{key}|{layout}"] for r in range(len(ranks))]
    if layout == "r":
        for b in blk[1:]:
            assert np.array_equal(b, blk[0]), f"{key}: ranks disagree"
        return blk[0]
    if layout == "each":
        return np.stack(blk)
    if layout == "t":
        return np.concatenate([blk[t] for t in range(tm)], axis=-1)
    if layout == "t0":  # channel blocks dealt over the time dimension
        return np.concatenate([blk[t] for t in range(tm)], axis=0)
    if layout == "c":
        return np.concatenate([blk[c * tm] for c in range(ch)], axis=0)
    rows = [np.concatenate([blk[c * tm + t] for t in range(tm)], axis=-1)
            for c in range(ch)]
    return np.concatenate(rows, axis=0)


def results(ranks: list[dict], name: str, shape) -> dict:
    """``{key: global value}`` of a case, or raise with a rank's error."""
    for r, d in enumerate(ranks):
        if f"{name}|error|" in d:
            raise AssertionError(f"rank {r}: {d[f'{name}|error|']}")
    keys = {k.split("|")[1]: k.split("|")[2] for k in ranks[0]
            if k.startswith(f"{name}|") and not k.endswith("|single")}
    return {k: assemble(ranks, shape, f"{name}|{k}", lay)
            for k, lay in keys.items()}


# -- the JAX references (the test process only: the worker imports none) --

def jmesh(key):
    import jax
    from modem_tpu import parallel as jp

    ch, tm = MESHES[key]
    return jp.make_modem_mesh(ch=ch, time=tm, devices=jax.devices()[:4])


def _jchains():
    from modem_tpu.chain import PulseShapedChain as JChain
    from modem_tpu.chain import qpsk_reference_chain as jqpsk
    from modem_tpu.config import Rates as JRates
    from modem_tpu.models.qam import QAM as JQAM

    JR = JRates(BAUD, SR)
    return {"qpsk": jqpsk(JR), "qpsk_pb": JChain(jqpsk(JR).scheme, JR,
                                                carrier_hz=CARRIER),
            "qam16": JChain(JQAM(4, 0.0, 6.0), JR),
            "qam16_pb": JChain(JQAM(4, 0.0, 6.0), JR, carrier_hz=CARRIER)}


def _noisy_llrs(shape, n_data, sigma, seed):
    import jax.numpy as jnp
    from modem_tpu.fec import ccsds_code as jccsds

    rng = np.random.default_rng(seed)
    bits = jnp.asarray(rng.integers(0, 2, shape + (n_data,)), jnp.int32)
    c = np.asarray(jccsds().encode(bits)).astype(np.float32)
    y = 1.0 - 2.0 * c + sigma * rng.normal(size=c.shape).astype(np.float32)
    return np.asarray(2.0 * y / sigma ** 2, np.float32)


def jax_inputs(data: dict) -> dict:
    """The data plus the JAX objects' tables the port's objects are built
    from."""
    from modem_tpu import parallel as jp
    from modem_tpu.config import Rates as JRates
    from modem_tpu.models.qam import QAM as JQAM
    from modem_tpu.resampled import ResampledChain as JResampled
    from modem_tpu.rx import Demodulator as JDemod

    JR = JRates(BAUD, SR)
    d = dict(data)
    for name, c in _jchains().items():
        d[f"{name}_lut"] = np.asarray(c.lut)
        d[f"{name}_rrc"] = np.asarray(c.rrc)
        d[f"{name}_bps"] = np.int32(c.scheme.bits_per_symbol)
    for up, down in ((3, 2), (2, 3)):
        c = JResampled(JQAM(2, 0.0, 1.0), JR, up, down)
        for k in ("lut", "rrc", "taps1", "taps2"):
            d[f"rs{up}{down}_{k}"] = np.asarray(getattr(c, k), np.float32)
        q = jp.ShardedResampledChain(c, jmesh("22")).quantum
        d[f"bits_rs{up}{down}"] = _bits((4, 2 * 24 * q * 2), 41 + up)
        if (up, down) == (2, 3):
            d["bits_rs_bad"] = _bits((4, 2 * (24 * q + 1) * 2), 43)
    dm = JDemod(CARRIER, SR)
    d["demod_lowpass"] = np.asarray(dm.lowpass)
    d["demod_hilbert"] = np.asarray(dm.hilbert)
    d["vit_llr"] = _noisy_llrs((4,), 1002, 0.8, 6)
    d["vit_llr1"] = _noisy_llrs((), 1018, 0.7, 7)
    d["vit_win"] = _noisy_llrs((8,), 1000, 0.8, 1)
    return d


def _jfn(fn, mesh, in_specs, out_specs):
    import jax

    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def jax_refs(d: dict) -> dict:
    """Each case's JAX values, ``{case: {key: array}}``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from modem_tpu import Modulator as JModulator
    from modem_tpu import make_scheme as jmake_scheme
    from modem_tpu import parallel as jp
    from modem_tpu.chain import DifferentialChain as JDiff
    from modem_tpu.config import Rates as JRates
    from modem_tpu.fec import ccsds_code as jccsds
    from modem_tpu.models.qam import QAM as JQAM
    from modem_tpu.resampled import ResampledChain as JResampled
    from modem_tpu.rx import Demodulator as JDemod

    JR = JRates(BAUD, SR)
    m22, m14, m41 = jmesh("22"), jmesh("14"), jmesh("41")
    j = {}
    x = jnp.asarray(d["halo_x"])
    v = jnp.asarray([[1, 2], [2, 5], [3, 8], [4, 11]], jnp.int32).reshape(-1)
    j["halos"] = {
        "left": _jfn(lambda a: jp.left_halo(a, 2, "time"), m14, (P("time"),),
                     P("time"))(x),
        "right": _jfn(lambda a: jp.right_halo(a, 3, "time"), m14,
                      (P("time"),), P("time"))(x),
        "prefix": _jfn(lambda a: jp.exclusive_prefix(a, "time"), m14,
                       (P("time"),), P("time"))(v),
        "psum": np.asarray([10, 26], np.int32)}
    x2 = jnp.asarray(d["halo_x2"])
    j["halos_2d"] = {
        "left": _jfn(lambda a: jp.left_halo(a, 2, "time"), m22,
                     (P("ch", "time"),), P("ch", "time"))(x2),
        "right": _jfn(lambda a: jp.right_halo(a, 3, "time"), m22,
                      (P("ch", "time"),), P("ch", "time"))(x2)}
    j["mesh"] = {"coord": np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]]),
                 "inferred": np.asarray([1, WORLD]), "refused": np.asarray(1),
                 "cuda_default": np.asarray(1), "block": d["halo_x2"]}
    ch = _jchains()
    j["channel_sharded"] = {"bits": jp.channel_sharded(
        ch["qpsk"].roundtrip, m41)(jnp.asarray(d["bits_ch"]))}
    j["fir"] = {"y": jp.sharded_fir(jnp.asarray(d["fir_x"]), d["fir_taps"],
                                    m14, batch_axis=None)}
    j["fir_2d"] = {"y": jp.sharded_fir(jnp.asarray(d["fir_x2"]),
                                       d["fir_taps2"], m22)}
    for b in FIR_BACKENDS:
        j[f"fir_{b}"] = {"y": jp.sharded_fir(
            jnp.asarray(d["fir_x"]), d["fir_taps"], m14, backend=b,
            batch_axis=None)}
    key0 = jax.random.key(0)
    for case, name, bits in (("staged_qpsk", "qpsk", "bits_qpsk"),
                             ("staged_qam16", "qam16", "bits_qam"),
                             ("staged_passband", "qpsk_pb", "bits_pb")):
        sc = jp.ShardedPulseChain(ch[name], m22)
        j[case] = {"bits": sc.roundtrip_fn()(
            sc.shard_bits(jnp.asarray(d[bits])), key0)}
    for b in FIR_BACKENDS:
        from modem_tpu.chain import qpsk_reference_chain as jqpsk

        sc = jp.ShardedPulseChain(jqpsk(JR, fir_backend=b), m22)
        j[f"staged_qpsk_{b}"] = {"bits": sc.roundtrip_fn()(
            sc.shard_bits(jnp.asarray(d["bits_qpsk"])), key0)}
    # the staged noisy paths draw from jax.random in JAX and from torch
    # generators in the port: held to the JAX test's claims (no error at 20
    # dB, errors at -6 dB and at -4 dB passband)
    for case, bits, snr in (("ber_20db", "bits_qpsk", 20.0),
                            ("ber_low_snr", "bits_ber", -6.0),
                            ("ber_passband", "bits_ber", -4.0)):
        j[case] = {"tot": np.asarray(d[bits].size),
                   "err_zero": np.asarray(snr > 0)}
    for case, name, bits in (("fused_qpsk", "qpsk", "bits_fused"),
                             ("fused_passband_qam16", "qam16_pb",
                              "bits_fused_qam")):
        sc = jp.ShardedPulseChain(ch[name], m22)
        j[case] = {"bits": sc.fused_roundtrip_fn()(
            sc.shard_bits(jnp.asarray(d[bits])), jnp.int32(0))}
    sc = jp.ShardedPulseChain(ch["qpsk"], m22)
    err, tot = sc.fused_ber_fn(BER_SNR_DB)(
        sc.shard_bits(jnp.asarray(d["bits_noisy"])), jnp.int32(SEED))
    j["fused_ber"] = {"err": err, "tot": tot}
    for case, name, bits in (("fused_txrx", "qpsk", "bits_tx"),
                             ("fused_txrx_passband", "qam16_pb",
                              "bits_tx_qam")):
        sc = jp.ShardedPulseChain(ch[name], m22)
        wave, ext = sc.fused_tx_fn()(sc.shard_bits(jnp.asarray(d[bits])))
        j[case] = {**{f"wave{i}": w for i, w in enumerate(wave)},
                   **{f"ext{i}": e for i, e in enumerate(ext)},
                   "bits": sc.fused_rx_fn()(wave, ext)}
    sd = jp.ShardedDifferentialChain(JDiff(jmake_scheme("dqpsk", JR), JR),
                                     m22)
    j["differential"] = {"bits": sd.fused_roundtrip_fn()(
        sd.shard_bits(jnp.asarray(d["bits_dq"])))}
    j["differential_refuses"] = {"refused": np.asarray(1)}
    for name in SCHEMES:
        si, sq = jp.time_sharded_baseband(
            JModulator(jmake_scheme(name, JR), JR),
            jnp.asarray(d[f"bits_mod_{name}"]), m14)
        j[f"baseband_{name}"] = {"i": si, "q": sq}
    si, sq = jp.time_sharded_baseband(
        JModulator(jmake_scheme("mfsk", JR), JR),
        jnp.asarray(d["bits_mod_2d"]), m22)
    j["baseband_2d_mfsk"] = {"i": si, "q": sq}
    dm = JDemod(CARRIER, SR)
    bmod = JModulator(jmake_scheme("bpsk", JR), JR, carrier_hz=CARRIER)
    for case, key, mesh, ax in (("demodulate", "bits_demod1", m14, None),
                                ("demodulate_2d", "bits_demod", m22, "ch")):
        bits = jnp.asarray(d[key])
        wave, _ = bmod.passband(bits, bmod.init_state(bits.shape[:-1]))
        i, q = jp.sharded_demodulate(dm, wave, mesh, ch_axis=ax)
        j[case] = {"i": i, "q": q}
    bits = jnp.asarray(d["bits_demod1"])
    wave, _ = bmod.passband(bits, bmod.init_state(bits.shape[:-1]))
    for b in FIR_BACKENDS:
        i, q = jp.sharded_demodulate(JDemod(CARRIER, SR, fir_backend=b), wave,
                                     m14, ch_axis=None)
        j[f"demodulate_{b}"] = {"i": i, "q": q}
    for case, name, key, snr, chunk, mesh in (
            ("fsk_mfsk", "mfsk", "bits_fsk_mfsk", None, None, m22),
            ("fsk_bfsk", "bfsk", "bits_fsk_bfsk", None, None, m22),
            ("fsk_mfsk_noisy", "mfsk", "bits_fsk_mfsk", FSK_SNR_DB, None,
             m22),
            ("fsk_1d_chunk32", "bfsk", "bits_fsk_1d", None, 32, m14)):
        fn = jp.time_sharded_fsk_roundtrip_fn(
            jmake_scheme(name, JR), JR, mesh, snr_db=snr, chunk_sym=chunk)
        j[case] = {"bits": fn(jnp.asarray(d[key]), SEED)}
    for up, down in ((3, 2), (2, 3)):
        sr = jp.ShardedResampledChain(JResampled(JQAM(2, 0.0, 1.0), JR, up,
                                                 down), m22)
        bits = sr.shard_bits(jnp.asarray(d[f"bits_rs{up}{down}"]))
        wave, drain = sr.fused_tx_fn()(bits)
        j[f"resampled_{up}_{down}"] = {
            **{f"wave{i}": w for i, w in enumerate(wave)},
            **{f"drain{i}": w for i, w in enumerate(drain)},
            "bits": sr.fused_rx_fn()(wave, drain),
            "quantum": np.asarray(sr.quantum)}
    j["resampled_misaligned"] = {"refused": np.asarray(1)}
    j["viterbi"] = {"bits": jp.sharded_viterbi_fn(jccsds(), m22)(
        jnp.asarray(d["vit_llr"]))}
    j["viterbi_1d"] = {"bits": jp.sharded_viterbi_fn(
        jccsds(), m14, batch_axis=None)(jnp.asarray(d["vit_llr1"]))}
    code = jccsds()
    j["viterbi_windowed"] = {"bits": jp.channel_sharded(
        lambda a: code.decode_soft_windowed(a, 160), m41)(
        jnp.asarray(d["vit_win"]))}
    tx, rx = d["lstats_tx"], d["lstats_rx"]
    j["linkstats_psum"] = {
        "bit_err": np.asarray((tx != rx).sum()), "bit_tot": np.asarray(
            tx.size), "blocks": np.asarray(WORLD)}
    return {c: {k: np.asarray(v) for k, v in vals.items()}
            for c, vals in j.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two worlds' results (started first) and the JAX references."""
    tmp = tmp_path_factory.mktemp("parallel")
    data = jax_inputs(make_data())
    npz = tmp / "inputs.npz"
    np.savez(npz, **data)
    w4 = start_world(HERE, npz, tmp / "w4", WORLD)
    w1 = start_world(HERE, npz, tmp / "w1", 1)
    refs = jax_refs(data)
    return {"data": data, "refs": refs,
            "w4": join_world(w4, tmp / "w4", WORLD),
            "w1": join_world(w1, tmp / "w1", 1)}


#: per case and key: None equal, a float the atol, "ber" the BER counts'
#: bar; keys not listed are held equal
TOLS = {
    "fir": {"y": 1e-5}, "fir_2d": {"y": 1e-5},
    "halos": {"left": 0.0, "right": 0.0}, "halos_2d": {"left": 0.0,
                                                       "right": 0.0},
    "fused_txrx": {"wave0": 1e-5, "wave1": 1e-5, "ext0": 1e-5,
                   "ext1": 1e-5},
    "fused_txrx_passband": {"wave0": 1e-5, "ext0": 1e-5},
    "demodulate": {"i": 1e-5, "q": 1e-5},
    "demodulate_2d": {"i": 1e-5, "q": 1e-5},
    **{f"fir_{b}": {"y": 1e-4} for b in FIR_BACKENDS},
    **{f"demodulate_{b}": {"i": 1e-5, "q": 1e-5} for b in FIR_BACKENDS},
    "resampled_3_2": {"wave0": 1e-6, "wave1": 1e-6, "drain0": 1e-6,
                      "drain1": 1e-6},
    "resampled_2_3": {"wave0": 1e-6, "wave1": 1e-6, "drain0": 1e-6,
                      "drain1": 1e-6},
}
for _n in SCHEMES + ["2d_mfsk"]:
    _tol = (2e-5 if _n in ("dqpsk", "dbpsk")
            else 1e-6 if _n in ("bfsk", "mfsk", "msk", "16cpfsk", "2d_mfsk")
            else None)
    TOLS[f"baseband_{_n}"] = {"i": _tol, "q": _tol}


def _hold(name: str, key: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, key, got.shape, want.shape)
    tol = TOLS.get(name, {}).get(key)
    if tol is None:
        assert np.array_equal(got, want), (name, key)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_equal_jax(runs, name):
    """The blocks of 4 gloo ranks, assembled, against the JAX sharded
    function on the same inputs and mesh shape."""
    got = results(runs["w4"], name, MESHES[CASES[name][0]])
    want = runs["refs"][name]
    if name == "fused_ber":
        assert int(got["tot"]) == int(want["tot"])
        jerr = int(want["err"])
        assert abs(int(got["err"]) - jerr) <= max(2, 1e-3 * jerr)
        return
    if name.startswith("ber_"):
        assert int(got["tot"]) == int(want["tot"])
        assert (int(got["err"]) == 0) == bool(want["err_zero"])
        return
    if name.startswith("resampled_") and "round" in got:
        # the one-call roundtrip decides as the TX then RX pair
        assert np.array_equal(got.pop("round"), want["bits"])
    if name == "fsk_mfsk_noisy":
        g, w = got["bits"], want["bits"]
        assert g.shape == w.shape and np.mean(g == w) >= 0.999
        sent = runs["data"]["bits_fsk_mfsk"]
        assert 0 < np.mean(w != sent) < 0.5
        return
    if name == "linkstats_psum":
        for key in ("bit_err", "bit_tot", "blocks"):
            assert int(got[key]) == int(want[key]), key
        return
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        _hold(name, key, got[key], want[key])


#: world-of-one cases held within an atol, not bit for bit: the fft
#: backend frames its windows from the block's start, and the sharded
#: demodulator filters the whole stream (the pre-lock products zeroed) where
#: the single-device one filters the stream after the lock
WORLD1_TOLS = {"demodulate_fft": 1e-6}


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[2] is not None])
def test_world_of_one_equals_single_device(runs, name):
    """On a 1x1 mesh each sharded call equals the single-device port's,
    bit for bit (:data:`WORLD1_TOLS` excepted)."""
    ranks = runs["w1"]
    got = results(ranks, name, (1, 1))
    singles = {k.split("|")[1]: v for k, v in ranks[0].items()
               if k.startswith(f"{name}|") and k.endswith("|single")}
    assert singles
    for key, want in singles.items():
        g = np.asarray(got[key])
        assert g.shape == want.shape, (key, g.shape, want.shape)
        if name in WORLD1_TOLS:
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=WORLD1_TOLS[name], err_msg=key)
        else:
            assert np.array_equal(g, want), key


def test_entry_points_refuse_the_cpu_unless_asked():
    """``initialize_multihost`` and ``make_modem_mesh`` build on the card
    unless the caller asks for the CPU: with no CUDA device they raise,
    before any process group is made; a mesh also needs one."""
    import torch.distributed as dist
    from modem_tpu_torch.parallel import make_modem_mesh
    from modem_tpu_torch.parallel.multihost import initialize_multihost

    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the card is the default there")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_multihost()
    with pytest.raises(RuntimeError, match="initialize"):
        make_modem_mesh(device_type="cpu")
    assert not dist.is_initialized()


def test_ranks_load_no_jax(runs):
    """The ranks ran the port alone: neither jax nor modem_tpu loaded."""
    for world in ("w4", "w1"):
        assert not any(bool(r["jax_loaded|flag|r"]) for r in runs[world])


def test_noiseless_cases_decode_every_bit(runs):
    """The noiseless sharded chains send every bit through."""
    d = runs["data"]
    for name, key in (("staged_qpsk", "bits_qpsk"),
                      ("staged_passband", "bits_pb"),
                      ("fused_qpsk", "bits_fused"),
                      ("fused_txrx_passband", "bits_tx_qam"),
                      ("differential", "bits_dq"),
                      ("resampled_2_3", "bits_rs23"),
                      ("fsk_bfsk", "bits_fsk_bfsk")):
        got = results(runs["w4"], name, MESHES[CASES[name][0]])["bits"]
        assert np.array_equal(got, d[key]), name


def test_staged_noise_draws_errors_at_low_snr_only(runs):
    """The staged noisy paths: no error at 20 dB, errors at -6 dB and at
    -4 dB passband (as ``tests/test_parallel.py`` holds JAX)."""
    w4 = runs["w4"]
    assert int(results(w4, "ber_20db", (2, 2))["err"]) == 0
    assert int(results(w4, "ber_low_snr", (2, 2))["err"]) > 0
    assert int(results(w4, "ber_passband", (2, 2))["err"]) > 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    run_worker(CASES, _Inputs(sys.argv[1]), sys.argv[2],
               *map(int, sys.argv[3:6]))
