"""A configuration brings its own field (``portbench/fields/<name>.py``):
a field added as files and entries alone runs a train and a frame cell,
with every hook served and its constants the ones the program is handed;
a configuration whose model its field does not run is refused in one
line before anything is drawn; and the paged field draws what the
drivers drew before fields existed, bit for bit."""

from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from portbench import control, harness, inputs
from portbench.reference import field as F
from portbench.reference import localize as RL
from portbench.tests import helpers

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"

THROWAWAY_FIELD = '''"""The paged field with one constant more, recording each
hook it serves (the extension test's throwaway)."""

import pathlib

import torch

from portbench import harness

PAGED = harness.load_module(pathlib.Path(__file__).with_name("paged.py"))
RUNS = PAGED.RUNS
SERVED = {"field": set()}


def _marked(scene, device):
    return scene._replace(consts={"marker": torch.ones(1, device=device)})


def train_scene(model, mix, seed, device):
    SERVED["train_scene"] = _marked(
        PAGED.train_scene(model, mix, seed, device), device)
    return SERVED["train_scene"]


def frame_scene(model, mix, seed, device):
    SERVED["frame_scene"] = _marked(
        PAGED.frame_scene(model, mix, seed, device), device)
    return SERVED["frame_scene"]


def features(model, scene):
    SERVED["features"] = scene
    inner = PAGED.features(model, scene)

    def field(params, pts, dtype, contracted=False):
        SERVED["field"].add(contracted)
        return inner(params, pts, dtype, contracted=contracted)

    return field
'''


def _add_config(root: pathlib.Path, name: str, model: dict,
                field: str | None = None) -> None:
    """A configuration file beside f2nerf-occ's and its entry."""
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "f2nerf-occ.json").read_text())
    conf["name"] = name
    conf["config"]["model"].update(model)
    if field is not None:
        conf["field"] = field
    (pb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "x",
                            "file": f"portbench/configs/{name}.json",
                            "reduced": ["sample_near"], "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def _add_cell(root: pathlib.Path, name: str, config: str, traffic: str,
              limits_of: str) -> None:
    """A cell with a copy of ``limits_of``'s limits, reporting what that
    cell reports end to end."""
    pb = root / "portbench"
    shutil.copy(pb / "limits" / f"{limits_of}.json",
                pb / "limits" / f"{name}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if limits_of in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


class Watch:
    """``hooks.program`` of both kinds: keeps the constants that the step
    is called with and that the localizer holds."""

    def __init__(self):
        self.step_consts, self.localizer_consts = [], []

    def program(self, *args):
        if len(args) == 1:
            self.localizer_consts.append(args[0].localizer.consts)
            return None
        step_fn = args[0]

        def step(*a, **kw):
            self.step_consts.append(kw["consts"])
            return step_fn(*a, **kw)

        return step


def test_a_field_added_as_files_and_entries(tmp_path, monkeypatch):
    root = helpers.tiny_checkout(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "fields" / "throwaway.py").write_text(THROWAWAY_FIELD)
    _add_config(root, "throwaway-field", {}, field="throwaway")
    _add_cell(root, "throwaway-train", "throwaway-field", "map-train",
              "occ-train")
    _add_cell(root, "throwaway-frames", "throwaway-field", "node-mode0",
              "occ-localize")
    for path, data in before.items():
        assert path.read_bytes() == data, path

    loaded = []
    load = harness.load_module

    def keep(path):
        mod = load(path)
        if path.name == "throwaway.py":
            loaded.append(mod)
        return mod

    monkeypatch.setattr(harness, "load_module", keep)
    for cell, scene_hook in (("throwaway-train", "train_scene"),
                             ("throwaway-frames", "frame_scene")):
        watch = Watch()
        rc, result, err = helpers.run_cpu(root, cell, hooks=watch)
        assert rc == 0, err
        assert result["correct"], result
        served = loaded[-1].SERVED
        scene = served[scene_hook]
        assert served["features"] is scene
        assert served["field"] == ({False, True} if cell.endswith("train")
                                   else {False})
        # the field's constants are what the program is handed
        if scene_hook == "train_scene":
            assert watch.step_consts
            assert all(c["field"] is scene.consts for c in watch.step_consts)
        else:
            (held,) = watch.localizer_consts
            assert set(held["field"]) == set(scene.consts)
            for k, v in scene.consts.items():
                assert held["field"][k].data_ptr() == v.data_ptr(), k


@pytest.mark.parametrize("model, field, message", [
    ({"warp_mode": "perspective"}, None,
     "field 'paged' does not run warp_mode 'perspective'; add "
     "portbench/fields/<name>.py and name it in the configuration"),
    ({"hash_mode": "xor"}, None,
     "field 'paged' does not run hash_mode 'xor'; add "
     "portbench/fields/<name>.py and name it in the configuration"),
    ({}, "nowhere",
     "configuration 'throwaway-refused' names field 'nowhere'; add "
     "portbench/fields/nowhere.py"),
], ids=["perspective", "xor", "missing-field-file"])
def test_a_model_its_field_does_not_run_is_refused(tmp_path, monkeypatch,
                                                   model, field, message):
    root = helpers.tiny_checkout(tmp_path)
    _add_config(root, "throwaway-refused", model, field=field)
    _add_cell(root, "throwaway-refused-train", "throwaway-refused",
              "map-train", "occ-train")

    def drawn(*args, **kw):
        raise AssertionError("weights drawn for a refused configuration")

    monkeypatch.setattr(inputs, "map_weights", drawn)
    rc, result, err = helpers.run_cpu(root, "throwaway-refused-train")
    assert rc == 2 and result is None
    assert err.strip().splitlines()[-1] == f"portbench: {message}"
    with pytest.raises(SystemExit) as stop:
        next(control.readings(root, "throwaway-refused-train", [1], 0.1, (),
                              device="cpu"))
    assert stop.value.code == 2


# -- the paged field against the calls it replaced ---------------------------
# Copies of what the drivers called before fields existed: inputs.py's
# map_weights, cameras and seeded_grid, and reference/field.py's field.

def _parent_seeded_grid(model, seed: int, device) -> torch.Tensor:
    res = model.occ_grid_res
    occ_rng = np.random.default_rng(seed)
    seeded = ((occ_rng.random((res, res, res)) < 0.25).astype(np.float32)
              * np.float32(2.0 * F.sigma_threshold(model)))
    return torch.as_tensor(np.stack([seeded, seeded]), device=device)


def _parent_cameras(n_images: int, hw: int, focal: float, device):
    poses = torch.eye(3, 4, device=device).repeat(n_images, 1, 1)
    intr = torch.tensor([[focal, 0, hw / 2], [0, focal, hw / 2],
                         [0, 0, 1.0]], device=device).repeat(n_images, 1, 1)
    return poses, intr


def _parent_map_weights(model, n_images: int, seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    lay = F.layout(model)

    def uniform(bound, *shape):
        return torch.rand(shape, generator=g, device=device) * (2 * bound) \
            - bound

    pool = uniform(1.0, lay.total_pages, model.n_channels, F.BLOCK, F.BLOCK,
                   F.BLOCK)
    in_dim = model.n_levels * model.n_channels
    mlp = {"w": uniform(in_dim ** -0.5, in_dim, model.hash_feat_dim),
           "b": uniform(in_dim ** -0.5, model.hash_feat_dim)}
    mlp["b"][0] = 4.0
    d_in = model.hash_feat_dim + model.sh_degree ** 2
    d_h = model.shader_hidden_dim
    shader = {"w0": uniform(d_in ** -0.5, d_in, d_h),
              "b0": uniform(d_in ** -0.5, d_h),
              "w1": uniform(d_h ** -0.5, d_h, 3),
              "b1": uniform(d_h ** -0.5, 3)}
    emb = torch.randn((n_images, model.app_emb_dim), generator=g,
                      device=device) * 0.1
    return {"field": {"feat_pool": pool, "mlp": mlp}, "shader": shader,
            "app_emb": emb}


def _parent_field(model):
    lay = F.layout(model)

    def field(params, pts, dtype, contracted=False):
        x = pts if contracted else F.contract(pts, model.contraction_radius)
        feat = F.encode(params["field"]["feat_pool"], x, lay, dtype)
        return feat @ params["field"]["mlp"]["w"] + \
            params["field"]["mlp"]["b"]

    return field


def _tiny(name: str, kind: str) -> tuple:
    conf = json.loads((PB / "configs" / "f2nerf-occ.json").read_text())
    model = {**conf["config"]["model"], **helpers.TINY_MODEL}
    mix = json.loads((PB / "mixes" / f"{name}.json").read_text())
    return F.model_ns(model), {**mix, **helpers.TINY_MIX[kind]}


def _same(a, b):
    """Nested dicts of tensors equal bit for bit."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_the_paged_field_draws_what_the_drivers_drew(seed):
    paged = harness.load_module(PB / "fields" / "paged.py")
    dev = torch.device("cpu")
    # training: the sub-seeds and draws of drive_train.py
    model, mix = _tiny("map-train", "train")
    s = inputs.sub_seeds(seed, ("weights", "grid", "batches"))
    scene = paged.train_scene(model, mix, s["weights"], dev)
    _same(scene.params, _parent_map_weights(model, int(mix["images"]),
                                            s["weights"], dev))
    poses, intr = _parent_cameras(int(mix["images"]), int(mix["image_hw"]),
                                  float(mix["focal"]), dev)
    assert torch.equal(scene.poses, poses) and torch.equal(scene.intr, intr)
    assert scene.consts == {}
    assert torch.equal(inputs.seeded_grid(model, s["grid"], dev),
                       _parent_seeded_grid(model, s["grid"], dev))
    # frames: the sub-seeds, draws and target frames of drive_frames.py
    model, mix = _tiny("node-mode0", "frames")
    s = inputs.sub_seeds(seed, ("weights", "grid", "targets", "localizer",
                                "sample"))
    scene = paged.frame_scene(model, mix, s["weights"], dev)
    _same(scene.params, _parent_map_weights(model, 4, s["weights"], dev))
    assert scene.consts == {} and scene.poses is None
    grid = inputs.seeded_grid(model, s["grid"], dev)
    assert torch.equal(grid, _parent_seeded_grid(model, s["grid"], dev))
    full_hw, factor = tuple(mix["frame_hw"]), int(mix["resize_factor"])
    _, small = inputs.frame_intrinsic(full_hw, mix["focal"], factor)
    frames = []
    for field in (paged.features(model, scene), _parent_field(model)):
        mp = RL.Map(scene.params, model, field, F.occ_values(grid, model),
                    small, full_hw[0] // factor, full_hw[1] // factor,
                    F.table_dtype(model))
        frames.append(inputs.target_frames(
            mp, np.random.default_rng(s["targets"]), int(mix["targets"]),
            float(mix["target_shift"]), full_hw, factor))
    for a, b in zip(*frames):
        assert np.array_equal(a, b)
