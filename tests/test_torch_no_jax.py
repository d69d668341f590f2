"""The PyTorch port stands alone: importing ``modem_tpu_torch`` and every one
of its modules in a fresh interpreter loads neither ``jax`` nor the JAX
package ``modem_tpu``, and no source file of the port imports them."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "modem_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def _imports(path: pathlib.Path) -> set[str]:
    """Top-level names of every absolute import in a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'modem_tpu' or m.startswith('modem_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_listed():
    assert "modem_tpu_torch" in MODULES and "modem_tpu_torch.ops.txrx" in MODULES
    assert "modem_tpu_torch.cli.demodulate" in MODULES
    assert "modem_tpu_torch.ops.fsk_kernel" in MODULES
    assert "modem_tpu_torch.gmsk" in MODULES
    assert "modem_tpu_torch.resampled" in MODULES
    assert "modem_tpu_torch.ops.resampled_kernel" in MODULES
    assert "modem_tpu_torch.ops.resample" in MODULES
    for m in ("fec", "fec.conv", "fec.crc", "fec.interleave", "fec.puncture",
              "fec.rs", "fec.scramble", "ops.viterbi_kernel", "link",
              "presets", "cli.link", "utils.cache", "harness", "checkpoint",
              "metrics", "ops.channel", "fec.turbo", "fec.polar",
              "ops.bcjr_kernel", "ops.sc_kernel", "ops.scl_kernel",
              "fec.ldpc", "ops.sync_metric", "ofdm", "fec.bch",
              "ops.impairments", "ops.agc", "ops.equalizer", "sync",
              "scfde", "stbc", "mimo", "bitloading", "ops.channelizer",
              "dsss", "fhss", "wideband", "profiling", "debug", "parallel",
              "parallel.mesh", "parallel.multihost", "parallel.collectives",
              "parallel.generic", "parallel.fir", "parallel.chain",
              "parallel.modulator", "parallel.rx", "parallel.fsk",
              "parallel.resampled", "parallel.viterbi", "parallel.acquire",
              "parallel.ofdm", "parallel.channelizer"):
        assert f"modem_tpu_torch.{m}" in MODULES, m
    assert len(MODULES) >= 86


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_no_jax(path):
    bad = _imports(path) & {"jax", "jaxlib", "modem_tpu"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.mark.parametrize(
    "path", [ROOT / "chip_smoke.py", ROOT / "probe_long_core.py"]
    + sorted(ROOT.glob("bench_*_torch.py")), ids=lambda p: p.name)
def test_scripts_import_no_jax(path):
    """``chip_smoke.py``, the A/B scripts and the timing probes run where
    there is no JAX."""
    bad = _imports(path) & {"jax", "jaxlib", "modem_tpu"}
    assert not bad, f"{path.name} imports {sorted(bad)}"
