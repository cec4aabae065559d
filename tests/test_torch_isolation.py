"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
no JAX and nothing of the JAX package ``repro``, and the entry points ask
for the CUDA card unless told otherwise."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_scan_covers_every_port_module():
    """The scans below glob the package, so a new module (the paper
    flow's ``core/codegen.py`` and ``train/optimizer.py`` among them) is
    covered as it lands."""
    mods = set(_module_names())
    assert {"repro_torch.core.chaotic", "repro_torch.core.ann",
            "repro_torch.core.codegen", "repro_torch.train",
            "repro_torch.train.optimizer",
            "repro_torch.kernels.chaotic_ann"} <= mods
    assert PORT / "core" / "chaotic.py" in PORT_FILES
    assert PORT / "core" / "codegen.py" in PORT_FILES


def test_port_imports_with_jax_blocked():
    """A subprocess where ``import jax`` fails imports every module of the
    port and chip_smoke.py, and finds no ``repro`` module loaded."""
    mods = list(_module_names())
    script = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        "import importlib",
        f"for m in {mods!r}: importlib.import_module(m)",
        "import chip_smoke",
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None "
        "and (m.split('.')[0] in ('repro', 'jax', 'jaxlib')))",
        "assert not bad, bad",
        "print('ISOLATED', len(sys.modules))",
    ])
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED" in r.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_service_without_device_raises_where_there_is_no_card():
    from repro_torch.prng.stream import default_params
    from repro_torch.serve.prng_service import PRNGService
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PRNGService(default_params())
    assert PRNGService(default_params(), device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(ROOT))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
