"""The port's public surface against the JAX package's, from the sources
alone (both parsed with ``ast``; neither package is imported).

For every module of ``modem_tpu/`` the port has its counterpart at the same
path (``ops/pallas_<name>.py``: ``ops/<name>_kernel.py``, K2/K3's
``ops/txrx.py`` and K4's ``ops/fir.py``), every public function and class
of the JAX module is there, and every parameter of each function, of each
class's constructor and of each public method is a parameter of the port's
counterpart. The differences made by design (``ROADMAP.md`` queue 3) are
:data:`ALLOWED`, each with its reason; an entry that is no longer a
difference fails too, so the list stays exact.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "modem_tpu", ROOT / "modem_tpu_torch"
JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))
#: counterparts whose name is not ``pallas_<name>`` -> ``<name>_kernel``
RENAMED = {"ops/pallas_txrx.py": "ops/txrx.py",
           "ops/pallas_fir.py": "ops/fir.py"}

_DEVICE = "dispatch goes by the tensor's device, not a backend= option"
_TPU = "a Pallas/Mosaic knob (interpret mode, a kernel width, a VMEM tile)"
_PYTREE = "a JAX pytree method; the port's state is a plain dataclass"
_KEY = "a torch.Generator (generator=) stands where JAX takes a PRNG key"
_MESH = ("a DeviceMesh and its process groups stand where JAX has a Mesh "
         "and axis names")
_ENTRY = ("the Mosaic kernel's own entry; the Hopper kernel decodes or "
          "filters whole rows through the module's other functions")

#: (JAX module, name, parameter or None for the name itself) -> reason
ALLOWED = {
    ("fec/conv.py", "ConvCode.decode_soft_windowed", "backend"): _DEVICE,
    ("fec/conv.py", "StreamingViterbi.__init__", "backend"): _DEVICE,
    ("fec/polar.py", "PolarCode.decode", "backend"): _DEVICE,
    ("fec/polar.py", "PolarCode.decode_list", "backend"): _DEVICE,
    ("fec/turbo.py", "TurboCode.decode", "backend"): _DEVICE,
    ("fec/polar.py", "PolarCode.decode", "kernel_w"): _TPU,
    ("fec/polar.py", "PolarCode.decode", "interpret"): _TPU,
    ("fec/polar.py", "PolarCode.decode_list", "kernel_w"): _TPU,
    ("fec/polar.py", "PolarCode.decode_list", "interpret"): _TPU,
    ("ops/pallas_bcjr.py", "bcjr_windowed", "interpret"): _TPU,
    ("ops/pallas_chain.py", "fused_pulse_chain", "interpret"): _TPU,
    ("ops/pallas_chain.py", "fused_pulse_chain_qam", "interpret"): _TPU,
    ("ops/pallas_demod.py", "fused_product_detect", "chunk"): _TPU,
    ("ops/pallas_demod.py", "fused_product_detect", "interpret"): _TPU,
    ("ops/pallas_fsk.py", "fsk_decide_from_program", "interpret"): _TPU,
    ("ops/pallas_fsk.py", "fused_fsk_chain", "interpret"): _TPU,
    ("ops/pallas_fsk.py", "fused_msk_slots", "interpret"): _TPU,
    ("ops/pallas_fsk.py", "fused_fsk_tx", "chunk_sym"): _TPU,
    ("ops/pallas_fsk.py", "fused_fsk_tx", "interpret"): _TPU,
    ("ops/pallas_fsk.py", "fused_discriminator_means", "chunk_groups"): _TPU,
    ("ops/pallas_fsk.py", "fused_discriminator_means", "interpret"): _TPU,
    ("ops/pallas_fsk.py", "fused_msk_tx", "chunk_slots"): _TPU,
    ("ops/pallas_fsk.py", "fused_msk_tx", "interpret"): _TPU,
    ("ops/pallas_resampled.py", "fused_resampled_tx", "chunk_sym"): _TPU,
    ("ops/pallas_resampled.py", "fused_resampled_tx", "interpret"): _TPU,
    ("ops/pallas_resampled.py", "fused_resampled_rx", "chunk_sym"): _TPU,
    ("ops/pallas_resampled.py", "fused_resampled_rx", "interpret"): _TPU,
    ("ops/pallas_txrx.py", "fused_tx", "chunk_sym"): _TPU,
    ("ops/pallas_txrx.py", "fused_tx", "interpret"): _TPU,
    ("ops/pallas_txrx.py", "fused_rx", "chunk_sym"): _TPU,
    ("ops/pallas_txrx.py", "fused_rx", "interpret"): _TPU,
    ("ops/pallas_viterbi.py", "viterbi_decode_windows", "interpret"): _TPU,
    ("ops/pallas_viterbi.py", "viterbi_decode_stream", "interpret"): _TPU,
    ("parallel/fsk.py", "time_sharded_fsk_roundtrip_fn", "interpret"): _TPU,
    ("ops/pallas_fir.py", "pallas_fir", None): _ENTRY,
    ("ops/pallas_sc.py", "sc_subtree", None): _ENTRY,
    ("ops/pallas_scl.py", "scl_subtree", None): _ENTRY,
    ("metrics.py", "LinkStats.tree_flatten", None): _PYTREE,
    ("metrics.py", "LinkStats.tree_unflatten", None): _PYTREE,
    ("rx.py", "RxState.tree_flatten", None): _PYTREE,
    ("rx.py", "RxState.tree_unflatten", None): _PYTREE,
    ("tx.py", "TxState.tree_flatten", None): _PYTREE,
    ("tx.py", "TxState.tree_unflatten", None): _PYTREE,
    ("ops/channel.py", "awgn", "key"): _KEY,
    ("ops/channel.py", "awgn_real", "key"): _KEY,
    ("resampled.py", "ResampledChain.ber", "key"): _KEY,
    ("metrics.py", "LinkStats.psum", "axis_name"): _MESH,
    ("parallel/collectives.py", "left_halo", "axis_name"): _MESH,
    ("parallel/collectives.py", "right_halo", "axis_name"): _MESH,
    ("parallel/collectives.py", "exclusive_prefix", "axis_name"): _MESH,
    ("parallel/fir.py", "fir_with_halo", "axis_name"): _MESH,
    ("parallel/viterbi.py", "viterbi_with_halo", "axis_name"): _MESH,
    ("parallel/mesh.py", "make_modem_mesh", "devices"): _MESH,
}


def counterpart(rel: str) -> str:
    """The port's module for the JAX module at ``rel``."""
    if rel in RENAMED:
        return RENAMED[rel]
    p = pathlib.PurePosixPath(rel)
    if p.name.startswith("pallas_"):
        return str(p.with_name(p.name[len("pallas_"):-3] + "_kernel.py"))
    return rel


def _params(fn: ast.FunctionDef) -> tuple[list[str], bool]:
    """The named parameters (``self``/``cls`` dropped) and whether the
    function takes ``**kwargs``."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
             if p.arg not in ("self", "cls")]
    return names, a.kwarg is not None


def surface(path: pathlib.Path) -> dict:
    """``{name: (params, takes **kwargs) or None}`` of a module's public
    functions, classes (None), and each class's constructor and public
    methods (``Class.method``)."""
    out = {}
    fns = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.parse(path.read_text()).body:
        if (not isinstance(node, fns + (ast.ClassDef,))
                or node.name.startswith("_")):
            continue
        if isinstance(node, fns):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, fns) and (sub.name == "__init__"
                                             or sub.name[0] != "_"):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
    return out


def differences(rel: str) -> set:
    """Every ``(rel, name, param or None)`` of the JAX module at ``rel``
    that its counterpart lacks."""
    mine, theirs = surface(JAX / rel), surface(PORT / counterpart(rel))
    out = set()
    for name, sig in mine.items():
        if name not in theirs:
            out.add((rel, name, None))
        elif sig is not None and theirs[name] is not None:
            params, any_kw = theirs[name]
            out.update((rel, name, p) for p in sig[0]
                       if p not in params and not any_kw)
    return out


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_has_its_counterpart(rel):
    """The port's module exists and lacks nothing of the JAX module's
    public surface beyond :data:`ALLOWED`."""
    assert (PORT / counterpart(rel)).is_file(), counterpart(rel)
    extra = sorted(differences(rel) - set(ALLOWED), key=str)
    assert not extra, f"the port lacks {extra}"


def test_allow_list_is_exact():
    """Every allowed entry is still a difference, and has its reason; none
    excuses the FIR engine, whose backends are all ported."""
    seen = set().union(*(differences(rel) for rel in JAX_MODULES))
    stale = sorted(set(ALLOWED) - seen, key=str)
    assert not stale, f"no longer differences: {stale}"
    assert all(ALLOWED.values())
    assert not [k for k in ALLOWED if k[0] == "ops/fir.py"
                or k[2] in ("fir_backend",)]


def test_the_walk_sees_the_surface():
    """The walk reads what it should: the FIR engine's ``backend`` and the
    Demodulator's ``fir_backend`` on both sides, the counterparts'
    names."""
    for pkg in (JAX, PORT):
        fir = surface(pkg / "ops/fir.py")
        assert "backend" in fir["fir_filter"][0]
        demod = surface(pkg / "rx.py")["Demodulator.__init__"]
        assert "fir_backend" in demod[0]
    assert counterpart("ops/pallas_chain.py") == "ops/chain_kernel.py"
    assert counterpart("ops/pallas_txrx.py") == "ops/txrx.py"
    assert counterpart("ops/pallas_fir.py") == "ops/fir.py"
    assert len(JAX_MODULES) > 80
