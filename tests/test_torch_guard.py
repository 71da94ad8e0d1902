"""Guards on the port's boundaries: it imports neither JAX nor the reference
package, its entry points never fall back to the CPU on their own, and the
reference's params load into it unchanged."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from repro.configs import registry as jreg
from repro.core.quantize import QuantizedWeight as JQW
from repro.models import api as japi
from repro_torch.configs import registry as treg
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models.convert import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# build/ (gitignored) holds only what the kernels' build writes
PORT_FILES = sorted(p for p in PORT.rglob("*.py")
                    if p.relative_to(PORT).parts[0] != "build") + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_sources_import_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_port_package_loads_without_jax_or_reference():
    """Importing every module of the port pulls in neither JAX nor repro."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_serve_without_a_card_raises(monkeypatch):
    """No --device cpu and no CUDA device: the entry point refuses to run
    rather than serve on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])


@pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                   "from_jax_params"])
def test_api_without_a_card_raises(monkeypatch, entry):
    """The library entry points default to the card too: without a device
    argument and without CUDA they raise instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.get_reduced("tinyllama-1.1b")
    calls = {
        "init_params": lambda: tapi.init_params(torch.Generator(), cfg),
        "init_cache": lambda: tapi.init_cache(cfg, 1, 8),
        "from_jax_params": lambda: from_jax_params({"layers": {}}, cfg),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_serve_on_cpu_when_asked(capsys):
    assert serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                       "--max-new", "3", "--max-seq", "32",
                       "--mode", "lut_pallas"]) == 0
    assert "served 2 requests / 6 tokens" in capsys.readouterr().out


def test_from_jax_params_roundtrips_a_reduced_tree():
    cfg = jreg.get_reduced("tinyllama-1.1b")
    params = japi.init_params(jax.random.key(0), cfg, serve_quantized=True)
    np_tree = jax.tree.map(np.asarray, params)
    port = from_jax_params(np_tree, treg.get_reduced("tinyllama-1.1b"),
                           "cpu")
    assert len(port["layers"]) == cfg.n_layers

    def check(ref, got, index):
        if isinstance(ref, JQW):
            assert isinstance(got, QuantizedWeight)
            for name in ("packed", "scale"):
                want = getattr(ref, name)
                want = want if index is None else want[index]
                np.testing.assert_array_equal(getattr(got, name).numpy(), want)
            assert got.zero_prime is None and ref.zero_prime is None
            assert (got.plane_scales, got.bits, got.k_group, got.k_total,
                    got.n) == (ref.plane_scales, ref.bits, ref.k_group,
                               ref.k_total, ref.n)
        elif isinstance(ref, dict):
            assert set(ref) == set(got)
            for k in ref:
                check(ref[k], got[k], index)
        else:
            np.testing.assert_array_equal(
                got.numpy(), ref if index is None else ref[index])

    for k in np_tree:
        if k == "layers":
            for i in range(cfg.n_layers):
                check(np_tree[k], port[k][i], i)
        else:
            check(np_tree[k], port[k], None)
