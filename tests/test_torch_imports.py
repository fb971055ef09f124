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
                 "utils.undistort", "tools", "tools.common", "tools.eval",
                 "tools.make_synthetic_dataset", "tools.quality_run",
                 "tools.eval_holdout", "tools.localize_validation",
                 "tools.localize_envelope", "tools.bench_localize",
                 "tools.inter_poses", "tools.replay_dataset",
                 "tools.resize_images", "tools.crop_images",
                 "tools.rectify_images", "tools.concat_inference_images",
                 "tools.train_synthetic", "tools.rosbag_reader",
                 "tools.interpolate", "tools.extract_images_from_rosbag",
                 "tools.convert_pose_tsv_to_f2_format", "tools.particles_log",
                 "tools.modified_offset_by_particles_log",
                 "tools.bench_step_parts", "tools.bench_encode_parts",
                 "tools.bench_dense_parts", "tools.bench_dense_trained",
                 "tools.diag_holdout", "tools.eval_appearance_ab",
                 "tools.bench_scaling", "bench", "graft_entry"):
        assert f"f2nerf_tpu_torch.{name}" in PORT_MODULES, name
    assert len(PORT_MODULES) >= 78


@pytest.fixture(scope="module")
def smoke_loaded():
    return _loaded(["chip_smoke"])


@pytest.fixture(scope="module")
def port_loaded():
    return _loaded(PORT_MODULES)


def test_port_imports_no_jax(port_loaded):
    assert _jax_like(port_loaded) == []
    assert "torch" in port_loaded


@pytest.mark.parametrize("banned", ["yaml", "PIL", "matplotlib"])
def test_port_imports_no_uninstalled(port_loaded, banned):
    """Every port module, the data-prep tools and the parts benches
    included, loads none of what the machine with the card lacks."""
    assert "f2nerf_tpu_torch.tools.extract_images_from_rosbag" in port_loaded
    assert not any(m == banned or m.startswith(banned + ".")
                   for m in port_loaded)


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
