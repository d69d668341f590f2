"""The port's ``modulate``/``demodulate`` CLIs and wire formats vs the JAX
package's on the same stdin bytes, with ``--device cpu``.

Tolerances: ``modulate`` output compared as floats, ``atol=1e-6`` (the trig
of two libraries); ``demodulate`` text parsed (6 significant digits),
``rtol=1e-4`` plus ``atol=2e-4`` near zero; chunked vs one shot byte for
byte, as ``tests/test_io_cli.py``.
"""

import io as _stdio

import numpy as np
import pytest
import torch

from modem_tpu.cli import demodulate as j_demod_cli
from modem_tpu.cli import modulate as j_mod_cli

from modem_tpu_torch import Demodulator
from modem_tpu_torch import io as mio
from modem_tpu_torch.cli import demodulate as cli_demod
from modem_tpu_torch.cli import modulate as cli_mod

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


class _TinyChunkReader(_stdio.BytesIO):
    """A stream that returns at most ``n`` bytes per read."""

    def __init__(self, data: bytes, n: int):
        super().__init__(data)
        self._n = n

    def read(self, size=-1):
        return super().read(self._n if size is None or size < 0
                            else min(size, self._n))


def _run(cli, argv, stdin) -> bytes:
    out = _stdio.BytesIO()
    cli.run(cli.build_parser().parse_args(argv), stdin, out)
    return out.getvalue()


def _ascii_bits(n, seed=0, sep=""):
    bits = np.random.default_rng(seed).integers(0, 2, n)
    return sep.join("01"[b] for b in bits).encode()


def _parse_text(raw: bytes) -> np.ndarray:
    return np.array([float(v.split(b":")[1]) for line in raw.splitlines()
                     for v in line.split(b"\t")])


def _i16(n, seed):
    return (np.random.default_rng(seed).integers(-2000, 2000, n)
            .astype("<i2").tobytes())


# ---- wire formats ----

def test_native_matches_numpy():
    lib = mio._native()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    x = rng.normal(size=257).astype(np.float32)
    data = mio.f32_to_f32le(x)
    assert data == x.astype("<f4").tobytes()
    np.testing.assert_array_equal(mio.f32le_to_f32(data), x)
    words = rng.integers(-32768, 32768, 100).astype("<i2")
    np.testing.assert_array_equal(mio.i16le_to_f32(words.tobytes()),
                                  words.astype(np.float32))
    np.testing.assert_array_equal(mio.parse_ascii_bits(b"0\x851\xa00 1\n"),
                                  [0, 1, 0, 1])
    assert mio.format_iq_text(np.asarray([1.5]), np.asarray([-2.0])) \
        == b"i:1.5\tq:-2\n"
    np.testing.assert_array_equal(
        mio.interleave_iq(np.asarray([1.0, 2.0]), np.asarray([3.0, 4.0])),
        [1.0, 3.0, 2.0, 4.0])


def test_numpy_fallback_formats(monkeypatch):
    monkeypatch.setattr(mio, "_native", lambda: None)
    assert mio.parse_ascii_bits(b"01 10\n\t1\x850").tolist() == [0, 1, 1, 0, 1, 0]
    with pytest.raises(ValueError):
        mio.parse_ascii_bits(b"0102")
    assert mio.format_ascii_bits(np.asarray([1, 0, 1])) == b"101"
    assert mio.i16le_to_f32(b"\x01\x00\xff").tolist() == [1.0]
    assert mio.format_iq_text(np.asarray([1.5]), np.asarray([-2.0])) \
        == b"i:1.5\tq:-2\n"


def test_native_builds_into_the_port():
    assert mio.NATIVE_LIB.parent.name == "_build"
    assert mio.NATIVE_LIB.parent.parent.name == "modem_tpu_torch"


# ---- modulate ----

@pytest.mark.parametrize("argv", [
    ["-m", "qpsk", "-r", "10000", "-b", "1250", "--iq"],
    ["-m", "bpsk", "-r", "10000", "-b", "1250", "-c", "1000", "-p", "2"],
    ["-m", "mfsk", "-r", "10000", "-b", "1250", "-c", "2000",
     "--block-symbols", "7"],
    ["-m", "dqpsk"],
    ["-m", "msk", "-r", "8000", "-b", "1000", "-c", "1000", "-p", "3"],
], ids=["qpsk-iq", "bpsk-preamble", "mfsk-blocks", "dqpsk-defaults",
        "msk-preamble"])
def test_modulate_matches_jax_cli(argv):
    data = _ascii_bits(601, seed=1, sep=" ")
    want = mio.f32le_to_f32(_run(j_mod_cli, argv, data))
    got = mio.f32le_to_f32(_run(cli_mod, argv + CPU, data))
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_modulate_chunked_identical():
    data = _ascii_bits(2048, seed=2, sep=" ")
    argv = ["-m", "mfsk", "-r", "10000", "-b", "1250", "-c", "1000",
            "--block-symbols", "64"] + CPU
    one = _run(cli_mod, argv, data)
    assert _run(cli_mod, argv, _TinyChunkReader(data, 313)) == one


@pytest.mark.parametrize("argv", [
    ["-m", "bpsk", "-r", "1000", "-b", "100", "-c", "600"],
    ["-m", "bpsk", "-r", "10000", "-b", "220", "-c", "900", "-p", "1"],
], ids=["nyquist", "preamble-divisibility"])
def test_modulate_error_exits(argv):
    with pytest.raises(SystemExit):
        _run(cli_mod, argv + CPU, b"01")


def test_modulate_trailing_partial_symbol_dropped():
    raw = _run(cli_mod, ["-m", "qpsk", "-r", "8000", "-b", "1000", "--iq"]
               + CPU, b"011")
    assert mio.f32le_to_f32(raw).size == 2 * 8


# ---- demodulate ----

@pytest.mark.parametrize("fused", [False, True])
def test_demodulate_matches_jax_cli(fused):
    data = _i16(3001, seed=3) + b"\x7f"
    argv = ["-r", "10000", "-c", "900", "--block-samples", "512"] + (
        ["--fused"] if fused else [])
    want = _parse_text(_run(j_demod_cli, argv, data))
    got = _parse_text(_run(cli_demod, argv + CPU, data))
    assert got.size == want.size == 2 * (3001 - 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_demodulate_chunked_identical(fused):
    data = _i16(5000, seed=4) + b"\x7f"  # odd trailing byte
    argv = ["-r", "10000", "-c", "900", "--block-samples", "512"] + CPU + (
        ["--fused"] if fused else [])
    one = _run(cli_demod, argv, data)
    assert _run(cli_demod, argv, _TinyChunkReader(data, 1001)) == one


def test_demodulate_fused_flag_matches_staged():
    data = _i16(4000, seed=5)
    argv = ["-r", "10000", "-c", "900", "--block-samples", "512"] + CPU
    staged = _parse_text(_run(cli_demod, argv, data))
    fused = _parse_text(_run(cli_demod, argv + ["--fused"], data))
    np.testing.assert_allclose(fused, staged, rtol=1e-4, atol=2e-4)


def test_demodulate_matches_library():
    data = _i16(700, seed=6)
    x = np.frombuffer(data, "<i2").astype(np.float32)
    got = _parse_text(_run(cli_demod, CPU, data)).reshape(-1, 2)
    demod = Demodulator(900, 10000, device="cpu")
    st = demod.lock_phase(torch.as_tensor(x[:64]), demod.init_state())
    (i, q), _ = demod.demodulate(torch.as_tensor(x[64:]), st)
    np.testing.assert_allclose(got, torch.stack([i, q], -1).numpy(),
                               rtol=1e-4, atol=2e-4)


def test_demodulate_needs_lock_samples():
    with pytest.raises(SystemExit):
        _run(cli_demod, CPU, b"\x00\x00" * 10)


def test_clis_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_mod.build_parser().parse_args(["-m", "qpsk"]).device == "cuda"
    assert cli_demod.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(cli_mod, ["-m", "qpsk"], b"0101")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(cli_demod, [], _i16(100, seed=7))
