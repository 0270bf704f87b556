"""The port stands alone: every module of `lumina_t2x_tpu_torch`, and
`chip_smoke.py`, imported in a fresh interpreter, load no module of the JAX
package (`lumina_t2x_tpu`) and no `jax` (no third-party library the port
imports loads it either)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import importlib, json, pkgutil, sys
import lumina_t2x_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lumina_t2x_tpu_torch.__path__,
                                                "lumina_t2x_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names,
                  "jax_package": sorted(m for m in sys.modules if m == "lumina_t2x_tpu"
                                        or m.startswith("lumina_t2x_tpu.")),
                  "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))}))
"""


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(found["modules"]) > 80  # every subpackage was walked
    for name in ("lumina_t2x_tpu_torch.exps.longcontext_forward",
                 "lumina_t2x_tpu_torch.core.checkpoint", "lumina_t2x_tpu_torch.ops.cuda_lib"):
        assert name in found["modules"]
    assert found["jax_package"] == []
    assert found["jax"] == []
