"""Import hygiene: ``import slamtpu`` must be side-effect-free on devices.

A module-level ``jnp.*`` op initializes a JAX backend at import time: the
process then reserves the accelerator's memory before any entry point has
chosen its devices, and a second process on the same card fails.

These tests run in SUBPROCESSES because this test process's conftest pins a
CPU backend (and initializes it), which would mask the bug. They assert the
load-bearing property directly: after importing every slamtpu module and
``__graft_entry__``, NO JAX backend has been initialized.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

# heavy lane: each test spawns a subprocess that re-imports the whole package
# cold (~40 s each); excluded from the default fast lane (pytest.ini)
pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parent.parent

_NO_BACKEND_CHECK = """
import jax
from jax._src import xla_bridge
assert not xla_bridge._backends, (
    'importing slamtpu initialized JAX backends: %r' % list(xla_bridge._backends)
)
print('NO_BACKEND_INITIALIZED')
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=REPO,
        env=env,
    )


def test_import_all_slamtpu_modules_initializes_no_backend():
    r = _run(
        "import importlib, pkgutil\n"
        "import slamtpu\n"
        "for m in pkgutil.walk_packages(slamtpu.__path__, 'slamtpu.'):\n"
        "    importlib.import_module(m.name)\n"
        + _NO_BACKEND_CHECK
    )
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "NO_BACKEND_INITIALIZED" in r.stdout


def test_import_graft_entry_initializes_no_backend():
    r = _run("import __graft_entry__\n" + _NO_BACKEND_CHECK)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "NO_BACKEND_INITIALIZED" in r.stdout
