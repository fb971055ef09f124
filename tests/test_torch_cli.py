"""The port's entry points end to end on the CPU (``f2nerf_tpu_torch.apps.main``
train / test / render / infer, ``Localizer.from_checkpoint``), held
against the JAX CLI on the same trained params.

The workspace is ``tests/test_cli.py``'s (a 4-view 24x24 sphere, a
2-level dense-sampler model, 40 steps), trained by the port in process.
The same params then go into a JAX run directory (an Orbax checkpoint)
and into a converted run directory (``torch_params.npz``), so the JAX
CLI, the port reading its own checkpoint and the port reading the
converted file render one field. Tolerance: the renders atol 1e-5 (that
of ``tests/test_torch_render.py``); the written PNGs within one level of
255 (a render 1e-5 apart can round to the other side); the ``test``
scores rtol 1e-2: they score each render against the ground truth
resized to 3x3, which PIL (JAX) and torch (the port) resize up to one
level of 255 apart (``test_torch_localize.py::test_resize_image_vs_pil``),
and the score, n / sum(err^2), moves ~0.5% with that.

One test runs the port's ``train``, ``Localizer.from_checkpoint`` and a
render in a subprocess where importing ``yaml``, ``PIL``, ``jax`` or
``f2nerf_tpu`` raises ``ImportError``: the machine with the card has
neither ``yaml`` nor ``PIL``.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from f2nerf_tpu.apps import main as jcli
from f2nerf_tpu.core.config import Config as JConfig
from f2nerf_tpu.localize import localizer as jloc
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.train import checkpoint as jckpt
from f2nerf_tpu.train.optim import make_optimizer as jmake_optimizer
from f2nerf_tpu_torch.apps import main as tcli
from f2nerf_tpu_torch.convert import unflatten
from f2nerf_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from f2nerf_tpu_torch.data import dataset as tdata
from f2nerf_tpu_torch.data.synthetic import make_sphere_dataset
from f2nerf_tpu_torch.localize import localizer as tloc
from f2nerf_tpu_torch.train import checkpoint as tckpt
from f2nerf_tpu_torch.utils.image_io import read_image

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _cli_config() -> Config:
    """``tests/test_cli.py``'s workspace config."""
    return Config(
        model=ModelConfig(n_levels=2, n_channels=2, log2_table_size=11,
                          n_samples=24, sample_l=1.0 / 6.0,
                          bf16_features=False, sampler_mode="dense"),
        train=TrainConfig(pts_batch_size=16384, end_iter=40,
                          report_freq=20, vis_freq=20, save_freq=40,
                          learning_rate_warm_up_end_iter=10,
                          var_loss_start=10, var_loss_end=20))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    ds_dir, rd = root / "dataset", root / "run"
    rd.mkdir()
    ds = make_sphere_dataset(n_images=4, h=24, w=24)
    tdata.save_dataset(ds, ds_dir)
    _cli_config().save(rd / "train_config.yaml")
    tcli.main(["train", str(rd), str(ds_dir), *CPU])
    return rd, ds_dir, ds


def test_train_and_resume(workspace):
    rd, ds_dir, _ = workspace
    for name in ("train_log.txt", "inference_params.yaml",
                 "train_config.yaml"):
        assert (rd / name).is_file(), name
    log = (rd / "train_log.txt").read_text().splitlines()
    assert [ln.split("Iter:")[1].split()[0] for ln in log] == ["20", "40"]
    assert tckpt.latest_step(rd / "checkpoints") == 40
    vis = read_image(rd / "images" / "00000040_0.png")
    assert vis.shape == (24, 72, 3)                  # [gt | pred | depth]
    before = tckpt.restore(rd / "checkpoints")
    # at end_iter already: resumes, trains nothing, keeps the state
    tcli.main(["train", str(rd), str(ds_dir), *CPU])
    assert (rd / "train_log.txt").read_text().splitlines() == log
    after = tckpt.restore(rd / "checkpoints")
    assert after["step"] == 40
    for name, p in before["params"].items():
        assert np.array_equal(after["params"][name].numpy(), p.numpy())


def test_test_command(workspace):
    rd, ds_dir, ds = workspace
    tcli.main(["test", str(rd), str(ds_dir), *CPU])
    summary = (rd / "test_result" / "summary.tsv").read_text().splitlines()
    assert summary[0] == "average_time\taverage_score"
    t, s = (float(v) for v in summary[1].split("\t"))
    assert t > 0 and s > 0
    assert len(list((rd / "test_result").glob("*.png"))) == ds.n_images


def test_render_command(workspace, tmp_path):
    rd, _, ds = workspace
    np.save(tmp_path / "poses.npy", np.stack([ds.poses[0], ds.poses[1]]))
    out = tmp_path / "renders"
    tcli.main(["render", str(rd), str(tmp_path / "poses.npy"), str(out),
               *CPU])
    assert len(list(out.glob("*.png"))) == 2


def test_infer_command(workspace, monkeypatch):
    """One image at resize_factor 4 (32 would leave no pixels of 24)."""
    rd, ds_dir, _ = workspace
    real_load = tdata.load_dataset

    def load_one(d):
        full = real_load(d)
        return dataclasses.replace(
            full, poses=full.poses[:1], intrinsics=full.intrinsics[:1],
            dist_params=full.dist_params[:1], bounds=full.bounds[:1],
            images=full.images[:1])

    monkeypatch.setattr(tdata, "load_dataset", load_one)
    tcli.main(["infer", str(rd), str(ds_dir), "4", *CPU])
    pos = rd / "inference_result" / "0000" / "position.tsv"
    lines = pos.read_text().splitlines()
    assert lines[0] == "name\tx\ty\tz\tscore"
    names = [ln.split("\t")[0] for ln in lines[1:]]
    assert "original" in names and "noised_0" in names
    assert sum(n.startswith("optimized_") for n in names) == 8 * 10


def test_cli_needs_its_arguments(workspace):
    rd, _, _ = workspace
    with pytest.raises(SystemExit):
        tcli.main(["train", str(rd), *CPU])


@pytest.fixture(scope="module")
def converted(workspace, tmp_path_factory):
    """The trained params as a JAX run (Orbax checkpoint) and as a
    converted run (torch_params.npz), beside the port's run."""
    rd, _, ds = workspace
    root = tmp_path_factory.mktemp("converted")
    state = tckpt.restore(rd / "checkpoints")
    flat = {k: v.numpy() for k, v in state["params"].items()}
    grid = state["occ_grid"].numpy()
    runs = {"jax": root / "jax", "npz": root / "npz"}
    for d in runs.values():
        d.mkdir()
        for name in ("train_config.yaml", "inference_params.yaml"):
            (d / name).write_text((rd / name).read_text())
    np.savez(runs["npz"] / "torch_params.npz", **flat, occ_grid=grid)
    jcfg = JConfig.load(rd / "train_config.yaml")
    params = jax.tree.map(jnp.asarray, unflatten(flat))
    _, consts = jrend.init(jax.random.key(jcfg.train.seed), jcfg.model,
                           ds.n_images, np_seed=jcfg.train.seed)
    opt_state = jmake_optimizer(jcfg.train).init(params)
    jckpt.save(runs["jax"] / "checkpoints", state["step"], params, opt_state,
               consts, extra={"occ_grid": jnp.asarray(grid)})
    return runs


def test_from_checkpoint_sources(workspace, converted, tmp_path):
    """The port's checkpoint, the converted file and the JAX localizer's
    Orbax checkpoint render one field; an empty run raises naming both
    sources."""
    rd, _, ds = workspace
    jl = jloc.Localizer.from_checkpoint(converted["jax"])
    ref = np.asarray(jl.render_image(ds.poses[2]))
    assert ref.std() > 1e-3
    for d in (rd, converted["npz"]):
        tl = tloc.Localizer.from_checkpoint(d, device="cpu")
        np.testing.assert_allclose(tl.render_image(ds.poses[2]).numpy(), ref,
                                   rtol=0, atol=1e-5, err_msg=str(d))
    for name in ("train_config.yaml", "inference_params.yaml"):
        (tmp_path / name).write_text((rd / name).read_text())
    with pytest.raises(FileNotFoundError, match="torch_params.npz") as e:
        tloc.Localizer.from_checkpoint(tmp_path, device="cpu")
    assert "checkpoints" in str(e.value)


def test_test_and_render_match_jax_cli(workspace, converted, tmp_path):
    """The JAX CLI's test and render on the Orbax run against the port's
    on the converted run."""
    _, ds_dir, ds = workspace
    jrun, trun = converted["jax"], converted["npz"]
    jcli.main(["test", str(jrun), str(ds_dir)])
    tcli.main(["test", str(trun), str(ds_dir), *CPU])
    js, ts = ((d / "test_result" / "summary.tsv").read_text().splitlines()[1]
              for d in (jrun, trun))
    np.testing.assert_allclose(float(ts.split("\t")[1]),
                               float(js.split("\t")[1]), rtol=1e-2)
    for k in range(ds.n_images):
        # each file is [gt | pred] at 3x3: the renders agree to the PNG
        # level, the ground truths to the resize's one level
        a = read_image(jrun / "test_result" / f"{k:08d}.png")
        b = read_image(trun / "test_result" / f"{k:08d}.png")
        assert a.shape == b.shape == (3, 6, 3)
        assert np.abs(a - b).max() <= 1.0 / 255 + 1e-6
    np.save(tmp_path / "poses.npy", ds.poses[:3])
    jcli.main(["render", str(jrun), str(tmp_path / "poses.npy"),
               str(tmp_path / "j")])
    tcli.main(["render", str(trun), str(tmp_path / "poses.npy"),
               str(tmp_path / "t"), *CPU])
    for k in range(3):
        a = read_image(tmp_path / "j" / f"{k:05d}.png")
        b = read_image(tmp_path / "t" / f"{k:05d}.png")
        assert a.shape == b.shape == (ds.height, ds.width, 3)
        assert np.abs(a - b).max() <= 1.0 / 255 + 1e-6


_BLOCKED_RUN = r"""
import importlib.abc, json, sys
BLOCKED = ("yaml", "PIL", "jax", "f2nerf_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)

import numpy as np
from f2nerf_tpu_torch.apps import main as cli
from f2nerf_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from f2nerf_tpu_torch.data.dataset import save_dataset
from f2nerf_tpu_torch.data.synthetic import make_sphere_dataset
from f2nerf_tpu_torch.localize.localizer import Localizer

work = sys.argv[1]
ds = make_sphere_dataset(n_images=3, h=16, w=16)
save_dataset(ds, work + "/data")
import pathlib
pathlib.Path(work + "/run").mkdir()
Config(model=ModelConfig(n_levels=2, n_channels=2, log2_table_size=10,
                         n_samples=16, sample_l=1.0 / 4.0,
                         bf16_features=False, sampler_mode="dense"),
       train=TrainConfig(pts_batch_size=8192, end_iter=6, report_freq=3,
                         vis_freq=6, save_freq=6,
                         learning_rate_warm_up_end_iter=2)
       ).save(work + "/run/train_config.yaml")
cli.main(["train", work + "/run", work + "/data", "--device", "cpu"])
loc = Localizer.from_checkpoint(work + "/run", device="cpu")
rgb = loc.render_image(ds.poses[0]).numpy()
print(json.dumps({"shape": list(rgb.shape),
                  "finite": bool(np.isfinite(rgb).all()),
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in BLOCKED)}))
"""


def test_run_directory_without_yaml_or_pil(tmp_path):
    """train, from_checkpoint and a render with yaml, PIL and JAX
    unimportable: what the machine with the card can run."""
    code = _BLOCKED_RUN.replace("ROOT", repr(str(ROOT)), 1)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"shape": [16, 16, 3], "finite": True, "loaded": []}
    assert (tmp_path / "run" / "checkpoints" / "step_00000006").is_dir()
    assert len((tmp_path / "run" / "train_log.txt").read_text()
               .splitlines()) == 2
