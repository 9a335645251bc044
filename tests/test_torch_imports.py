"""The port imports neither JAX, flax nor the JAX package.

In a fresh interpreter where a ``sys.meta_path`` finder makes ``jax``,
``flax`` and ``cuahn_vio`` (and their submodules) unimportable, every
module of ``cuahn_vio_torch`` and the port's scripts (``chip_smoke.py``,
``tune_warp.py``, ``profile_slice.py``, ``smoke_reference.py``) must import.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARDED = r'''
import importlib
import importlib.abc
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "cuahn_vio")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())

import cuahn_vio_torch

names = ["cuahn_vio_torch"] + [
    m.name for m in pkgutil.walk_packages(cuahn_vio_torch.__path__, "cuahn_vio_torch.")
]
for name in names + ["chip_smoke", "profile_slice", "smoke_reference", "tune_warp"]:
    importlib.import_module(name)
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(names))
'''


def test_port_imports_without_jax_flax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", GUARDED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30  # every module was walked


def test_the_guard_blocks_what_it_names():
    """The finder really refuses the JAX package (so the test above can
    fail)."""
    probe = GUARDED.replace(
        'for name in names + ["chip_smoke", "profile_slice", "smoke_reference", "tune_warp"]:',
        'import cuahn_vio.ops.quat\nfor name in []:',
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "blocked import of cuahn_vio" in proc.stderr
