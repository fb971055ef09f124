"""Port parity for the ROS2 relay node (f2nerf_tpu_torch.apps.ros2_node
against f2nerf_tpu.apps.ros2_node) on the CPU, with stub rclpy and
message modules (rclpy exists only inside a ROS2 workspace).

* The message converters on ``tests/test_ros2_node.py``'s table of known
  rotations (written down by hand, so an order scramble at the ROS
  boundary cannot cancel) and the image round trip: bitwise.
* The node flow through ``main(argv)``: one run directory holding a
  JAX Orbax checkpoint and its ``torch_params.npz``
  (``scripts/export_torch_params.py``), each package's ``main`` with a
  stub ``rclpy.spin`` that activates the node, sends an initial pose
  2 cm off a training view and two bgr8 frames of that view. Published
  poses agree at ``test_torch_localize*.py``'s tolerances: mode 0 (the
  same particles and pixels from one seed) atol 1e-4, mode 1 (one Adam
  step at lr 1e-4) 0.01 lr x the scene radius.
* The port's node hands the service the frame as an array; with the
  nested list the JAX node sends, the published pose is the same bits.
"""

import importlib
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _ros2_stubs import Image, Pose, Quat, Vec, modules
from test_ros2_node import KNOWN_ROTATIONS

from f2nerf_tpu.apps import ros2_node as jrn_mod
from f2nerf_tpu.data.synthetic import make_sphere_dataset
from f2nerf_tpu.models import occupancy as jocc
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.train import checkpoint as jckpt
from f2nerf_tpu.train.optim import make_optimizer as jmake_optimizer
from f2nerf_tpu_torch.apps import ros2_node as trn_mod
from f2nerf_tpu_torch.localize import localizer as tloc

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_pose_converters_known_rotations():
    for (qx, qy, qz, qw), r in KNOWN_ROTATIONS:
        pose = Pose()
        pose.orientation = Quat(w=qw, x=qx, y=qy, z=qz)
        pose.position = Vec(1.0, -2.0, 3.5)
        mt = trn_mod.pose_msg_to_matrix(pose.position, pose.orientation)
        mj = jrn_mod.pose_msg_to_matrix(pose.position, pose.orientation)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_allclose(mt[:3, :3], r, atol=1e-6)
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = [0.5, 0.25, -1.0]
        at, aj = (mod.matrix_to_pose_msg(Pose, m)
                  for mod in (trn_mod, jrn_mod))
        for f in ("x", "y", "z", "w"):
            assert getattr(at.orientation, f) == getattr(aj.orientation, f)
        for f in ("x", "y", "z"):
            assert getattr(at.position, f) == getattr(aj.position, f)
    np.testing.assert_array_equal(trn_mod.output_covariance_diag(0.3),
                                  jrn_mod.output_covariance_diag(0.3))


@pytest.mark.parametrize("encoding", ["rgb8", "bgr8"])
def test_image_converters_bitwise(encoding):
    rng = np.random.default_rng(2)
    img = rng.random((6, 5, 3)).astype(np.float32)
    mt = trn_mod.array_to_image_msg(Image, img, "map", 7)
    mj = jrn_mod.array_to_image_msg(Image, img, "map", 7)
    assert mt.data == mj.data and mt.step == mj.step == 15
    assert (mt.height, mt.width, mt.encoding) == (6, 5, "rgb8")
    msg = Image()
    msg.height, msg.width, msg.encoding, msg.step = 4, 3, encoding, 10
    msg.data = rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
    for crop in (0, 2):
        a = trn_mod.image_msg_to_array(msg, crop_rows=crop)
        np.testing.assert_array_equal(a, jrn_mod.image_msg_to_array(msg, crop))
        assert a.dtype == np.float32 and a.shape == (crop or 4, 3, 3)
    msg.encoding = "mono8"
    with pytest.raises(ValueError, match="mono8"):
        trn_mod.image_msg_to_array(msg)


@pytest.fixture
def nodes(monkeypatch):
    """Both node modules reloaded against stub rclpy and message
    modules; ``spin`` hands the node to ``nodes.drive``."""
    state = types.SimpleNamespace(drive=None, nodes=[])

    def spin(node):
        state.nodes.append(node)
        state.drive(node)

    for name, m in modules(spin).items():
        monkeypatch.setitem(sys.modules, name, m)
    state.jax = importlib.reload(jrn_mod)
    state.port = importlib.reload(trn_mod)
    assert state.jax.HAVE_RCLPY and state.port.HAVE_RCLPY
    yield state
    monkeypatch.undo()
    importlib.reload(jrn_mod)
    importlib.reload(trn_mod)


@pytest.fixture(scope="module")
def run_dir(tiny_cfg, tmp_path_factory):
    """A JAX run directory of params with O(1) features (Orbax), with its
    torch_params.npz beside it; the sphere scene's views."""
    run = tmp_path_factory.mktemp("ros2_run")
    ds = make_sphere_dataset(n_images=4, h=24, w=24)
    params, consts = jrend.init(jax.random.key(tiny_cfg.train.seed),
                                tiny_cfg.model, ds.n_images,
                                np_seed=tiny_cfg.train.seed)
    rng = np.random.default_rng(5)
    tree = jax.tree.map(np.asarray, params)
    tree["field"]["feat_pool"] = rng.uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    tree["field"]["mlp"]["b"] = tree["field"]["mlp"]["b"].copy()
    tree["field"]["mlp"]["b"][0] = 6.0
    params = jax.tree.map(jnp.asarray, tree)
    tiny_cfg.save(run / "train_config.yaml")
    ds.save_inference_params(run)
    jckpt.save(run / "checkpoints", 1, params,
               jmake_optimizer(tiny_cfg.train).init(params), consts,
               extra={"occ_grid": jocc.init_grid(tiny_cfg.model)})
    spec = importlib.util.spec_from_file_location(
        "export_torch_params", ROOT / "scripts" / "export_torch_params.py")
    exporter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exporter)
    exporter.export(run)
    return run, ds


VIEW = 1


def _messages(run, ds):
    """An initial pose 2 cm off view VIEW and two bgr8 frames of it."""
    loc = tloc.Localizer.from_checkpoint(run, device="cpu")
    world = loc.camera2world(ds.poses[VIEW])
    world[:3, 3] += (0.012, -0.008, 0.014)
    init = types.SimpleNamespace(pose=types.SimpleNamespace(
        pose=trn_mod.matrix_to_pose_msg(Pose, world)))
    rgb = np.clip(ds.images[VIEW] * 255.0, 0, 255).astype(np.uint8)
    frames = []
    for stamp in (11, 12):
        m = Image()
        m.height, m.width, m.encoding = rgb.shape[0], rgb.shape[1], "bgr8"
        m.step = rgb.shape[1] * 3
        m.data = np.ascontiguousarray(rgb[..., ::-1]).tobytes()
        m.header.stamp = stamp
        frames.append(m)
    return init, frames


def _run_node(nodes, which, run, messages, mode, extra=()):
    init, frames = messages

    def drive(node):
        node.service.localizer._rng = np.random.default_rng(17)
        res = types.SimpleNamespace(success=None)
        node.service_trigger_node(types.SimpleNamespace(data=True), res)
        assert res.success and node.is_activated
        node.callback_initial_pose(init)
        for f in frames:
            node.callback_image(f)

    nodes.drive = drive
    argv = [str(run), "--optimization_mode", str(mode), "--resize_factor",
            "1", "--particle_num", "16", *extra]
    assert getattr(nodes, which).main(argv) == 0
    node = nodes.nodes[-1]
    assert not node.get_logger().errors
    return node


def _published(node):
    poses = [np.array([p.pose.position.x, p.pose.position.y,
                       p.pose.position.z, p.pose.orientation.x,
                       p.pose.orientation.y, p.pose.orientation.z,
                       p.pose.orientation.w])
             for p in node.pub_pose.published]
    return np.stack(poses), [s.data for s in node.pub_score.published]


@pytest.mark.parametrize("mode", [0, 1])
def test_node_matches_jax_node(nodes, run_dir, mode):
    run, ds = run_dir
    messages = _messages(run, ds)
    jn = _run_node(nodes, "jax", run, messages, mode)
    tn = _run_node(nodes, "port", run, messages, mode, ("--device", "cpu"))
    assert tn.service.localizer.device.type == "cpu"
    pj, sj = _published(jn)
    pt, st = _published(tn)
    assert pt.shape == (2, 7)
    for a in (pt, pj):        # q and -q are one rotation
        a[:, 3:] *= np.sign(a[:, 6:7])
    radius = float(ds.radius)
    atol = 1e-4 if mode == 0 else 0.01 * 1e-4 * radius
    np.testing.assert_allclose(pt, pj, rtol=0, atol=atol)
    np.testing.assert_allclose(st, sj, rtol=1e-3)
    for k, (a, b) in enumerate(zip(tn.pub_pose_cov.published,
                                   jn.pub_pose_cov.published)):
        assert a.pose.covariance == b.pose.covariance
        assert a.header.stamp == b.header.stamp == 11 + k
    img_t, img_j = tn.pub_image.published[-1], jn.pub_image.published[-1]
    assert (img_t.height, img_t.width) == (ds.height, ds.width)
    diff = np.abs(np.frombuffer(img_t.data, np.uint8).astype(int)
                  - np.frombuffer(img_j.data, np.uint8).astype(int))
    assert diff.max() <= 1
    # the 2 cm offset moved: the node localized, not echoed its prior
    assert np.abs(pt[-1, :3] - _published_prior(messages)).max() > 0


def _published_prior(messages):
    p = messages[0].pose.pose.position
    return np.array([p.x, p.y, p.z])


def test_node_array_equals_list(nodes, run_dir, monkeypatch):
    """Mode 0: the frame handed over as the float32 array and as the
    nested list publish the same pose, bit for bit."""
    run, ds = run_dir
    messages = _messages(run, ds)
    arr = _published(_run_node(nodes, "port", run, messages, 0,
                               ("--device", "cpu")))
    to_array = nodes.port.image_msg_to_array
    monkeypatch.setattr(nodes.port, "image_msg_to_array",
                        lambda *a: to_array(*a).tolist())
    lst = _published(_run_node(nodes, "port", run, messages, 0,
                               ("--device", "cpu")))
    np.testing.assert_array_equal(arr[0], lst[0])
    assert arr[1] == lst[1]


def test_main_without_rclpy(capsys):
    """Outside a ROS2 workspace main reports and returns 1."""
    if trn_mod.HAVE_RCLPY:
        pytest.skip("rclpy is installed here")
    assert trn_mod.main(["unused"]) == 1
    assert "rclpy" in capsys.readouterr().out
