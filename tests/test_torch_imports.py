"""Import guard: the port and chip_smoke.py load neither JAX nor the JAX
package, and chip_smoke.py loads no module that the machine with the
card does not install (yaml, PIL)."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in (ROOT / "f2nerf_tpu_torch").rglob("*.py"))

_PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(modules):
    code = _PROBE.format(root=str(ROOT), modules=list(modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _jax_like(loaded):
    return sorted(m for m in loaded
                  if m in ("jax", "jaxlib", "optax", "orbax", "f2nerf_tpu")
                  or m.startswith(("jax.", "jaxlib.", "optax.", "orbax.",
                                   "f2nerf_tpu.")))


def test_port_module_list_is_complete():
    assert "f2nerf_tpu_torch.kernels.trilinear" in PORT_MODULES
    assert "f2nerf_tpu_torch.apps.serve" in PORT_MODULES
    assert "f2nerf_tpu_torch.train.step" in PORT_MODULES
    assert "f2nerf_tpu_torch.train.optim" in PORT_MODULES
    for name in ("data.dataset", "data.synthetic", "data.native_loader",
                 "train.loop", "train.checkpoint", "apps.main",
                 "core.yaml_io", "utils.timer", "models.warp",
                 "apps.ros2_node", "ops.hash_encode", "utils.lpips",
                 "utils.undistort"):
        assert f"f2nerf_tpu_torch.{name}" in PORT_MODULES, name
    assert len(PORT_MODULES) >= 36


@pytest.fixture(scope="module")
def smoke_loaded():
    return _loaded(["chip_smoke"])


def test_port_imports_no_jax():
    loaded = _loaded(PORT_MODULES)
    assert _jax_like(loaded) == []
    assert "torch" in loaded


def test_chip_smoke_imports_no_jax(smoke_loaded):
    assert _jax_like(smoke_loaded) == []


@pytest.mark.parametrize("banned", ["yaml", "PIL"])
def test_chip_smoke_imports_no_uninstalled(smoke_loaded, banned):
    loaded = smoke_loaded
    for name in ("apps.serve", "apps.main", "train.step", "train.loop",
                 "data.dataset", "core.yaml_io"):
        assert f"f2nerf_tpu_torch.{name}" in loaded, name
    assert not any(m == banned or m.startswith(banned + ".")
                   for m in loaded)
