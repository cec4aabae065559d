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
    # the word-quality gates and the serving tier
    serving = {"repro_torch.prng.quality", "repro_torch.atomicio",
               "repro_torch.serve.clock", "repro_torch.serve.faults",
               "repro_torch.serve.health", "repro_torch.serve.admission",
               "repro_torch.serve.journal",
               "repro_torch.serve.async_frontend"}
    assert serving <= mods
    # the multi-device path
    assert {"repro_torch.distributed",
            "repro_torch.distributed.sharding"} <= mods
    assert PORT / "distributed" / "sharding.py" in PORT_FILES
    # the LM stack
    lm = {"repro_torch.configs", "repro_torch.configs.base",
          "repro_torch.configs.registry", "repro_torch.configs.llama3_2_3b",
          "repro_torch.models", "repro_torch.models.layers",
          "repro_torch.models.attention", "repro_torch.models.moe",
          "repro_torch.models.transformer", "repro_torch.serve.engine",
          "repro_torch.data", "repro_torch.data.pipeline",
          "repro_torch.distributed.compression", "repro_torch.tree",
          "repro_torch.train.train_step", "repro_torch.train.checkpoint",
          "repro_torch.train.loop", "repro_torch.launch",
          "repro_torch.launch.train"}
    assert lm <= mods, lm - mods
    assert len([m for m in mods if m.startswith("repro_torch.configs.")]) == 12
    for mod in serving:
        path = ROOT / "src" / (mod.replace(".", "/") + ".py")
        assert path in PORT_FILES, path


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


def test_journal_cli_runs_with_jax_blocked(tmp_path):
    """``python -m repro_torch.serve.journal <path>`` summarises a port
    journal in a process where ``import jax`` fails; exit 2 on mid-file
    damage, 0 after ``--repair``."""
    from repro_torch.clock import FakeClock
    from repro_torch.serve.journal import FlushJournal
    jpath = tmp_path / "farm.journal"
    with FlushJournal(jpath, clock=FakeClock()) as j:
        for c in ("a", "b", "c"):
            j.record_register("core0", c, seed=1)

    def cli(*args):
        script = "\n".join([
            "import runpy, sys",
            "sys.modules['jax'] = None",
            f"sys.path[:0] = [{str(ROOT / 'src')!r}]",
            f"sys.argv = ['journal', *{list(args)!r}]",
            "runpy.run_module('repro_torch.serve.journal', "
            "run_name='__main__')",
        ])
        return subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=300,
                              cwd=str(tmp_path))

    r = cli(str(jpath))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "registrations: 3" in r.stdout
    lines = jpath.read_text().splitlines()
    lines[1] = lines[1].replace('"ts"', '"tz"', 1)
    jpath.write_text("\n".join(lines) + "\n")
    assert cli(str(jpath)).returncode == 2
    r = cli(str(jpath), "--repair")
    assert r.returncode == 0 and "dropped 3" in r.stdout
