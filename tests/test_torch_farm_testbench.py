"""The port's ``generate_farm`` testbenches, one per registered system, on
the CPU, each held to the JAX farm testbench's outcome for that system
(``tests/test_farm.py::test_farm_testbenches_pass``).

chen, lorenz and rossler pass.  chua and hyperlorenz fail check 2,
"trajectory left attractor box" (max|x| < 10 over 512 steps), in the port
as in the JAX package: both read the registry weights of
``results/weights/``, retrained after the committed farm cores were
generated, under which the bf16 chua trajectory passes |x| = 10 at step
151 and hyperlorenz's at step 22 from the testbench's seed (ROADMAP.md
queue 3).  The older weights of the committed farm cores stay bounded;
the port reads the registry read-only and never retrains, so it cannot
repair this and must not hide it.
"""
import os
import subprocess
import sys

import pytest

from repro_torch.core.codegen import generate_farm

# the JAX testbench's outcome per system: None = passes, else the check
# that fails
OUTCOMES = {"chen": None, "lorenz": None, "rossler": None,
            "chua": "trajectory left attractor box",
            "hyperlorenz": "trajectory left attractor box"}


@pytest.fixture(scope="module")
def farm_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_farm")
    cores = generate_farm(out)
    assert sorted(cores) == sorted(OUTCOMES)
    return out


@pytest.mark.parametrize("name", sorted(OUTCOMES))
def test_generate_farm_testbench_outcome_is_the_jax_one(farm_dir, name):
    """Each emitted core's ``testbench.py cpu`` in its own process: exit 0
    and "TESTBENCH PASS" where the JAX testbench passes; exit 1 with the
    JAX testbench's failing check where it fails."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src, str(farm_dir), env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, str(farm_dir / name / "testbench.py"),
                        "cpu"], capture_output=True, text=True, env=env,
                       timeout=300)
    want = OUTCOMES[name]
    if want is None:
        assert r.returncode == 0, (name, r.stderr[-2000:])
        assert "TESTBENCH PASS" in r.stdout
    else:
        assert r.returncode == 1, (name, r.returncode, r.stdout[-500:])
        assert f"AssertionError: {want}" in r.stderr, r.stderr[-2000:]
        assert "TESTBENCH PASS" not in r.stdout
