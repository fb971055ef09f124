"""The port's data-prep tools (``f2nerf_tpu_torch/tools/``: rosbag_reader,
interpolate, extract_images_from_rosbag, convert_pose_tsv_to_f2_format,
particles_log, modified_offset_by_particles_log) against the JAX
package's scripts (``scripts/``) on the CPU.

What is held:
* the bag codec: the port's CDR bytes, ``.db3`` and ``.mcap`` files equal
  the JAX module's byte for byte, and each reads what the other writes;
* extraction of one bag holding PNG and JPEG ``CompressedImage`` frames
  and raw bgr8 and mono8 ``Image`` frames (a repeated frame dropped,
  poses bracketing the frames, a calibration with rotations): the same
  images (decoded, bitwise), the same ``pose.tsv`` texts (the quaternion
  helpers follow the same float64 operations, so the text is equal, not
  close), and a ``camera_info.yaml`` that PyYAML loads to the JAX
  script's dict;
* the converter's ``cams_meta.tsv`` text and the offset tool's printed
  report and written file (an Autoware ``/**:`` parameter file, key
  order kept), against the JAX scripts;
* fact 8 of the reference, in both packages: the extractor writes the
  ``camera_matrix`` form and the converter reads only ``K`` / ``D``;
* the tools run where ``jax``, ``PIL``, ``yaml`` and ``f2nerf_tpu`` raise
  on import.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import yaml
from PIL import Image
from scipy.spatial.transform import Rotation

from _lz4_frame import write_lz4_bag
from f2nerf_tpu_torch.tools import (convert_pose_tsv_to_f2_format,
                                    extract_images_from_rosbag, interpolate,
                                    modified_offset_by_particles_log,
                                    particles_log, rosbag_reader)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"


def _script(name: str):
    """A JAX script (``scripts/<name>.py``) as a module, loaded by path
    (its own ``sys.path`` insert finds its sibling modules)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbag():
    return _script("rosbag_reader")


def _run(main, argv, monkeypatch=None, name="script") -> str:
    """``main`` on ``argv`` (a JAX script's through ``sys.argv``), its
    standard output returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if monkeypatch is not None:
            monkeypatch.setattr(sys, "argv", [name, *argv])
            main()
        else:
            main(argv)
    return buf.getvalue()


# -- the bag -----------------------------------------------------------------

POSE_T = "geometry_msgs/msg/PoseWithCovarianceStamped"
CIMG_T = "sensor_msgs/msg/CompressedImage"
IMG_T = "sensor_msgs/msg/Image"
INFO_T = "sensor_msgs/msg/CameraInfo"
POSE_TOPIC = "/localization/pose_estimator/pose_with_covariance"
TOPICS = {f"/sensing/camera/camera{i}/image_rect_color/{kind}": kind
          for i, kind in enumerate(("png", "jpeg", "bgr8", "mono8"))}
H, W, N_FRAMES = 12, 16, 5


def _header(t: float, frame: str) -> dict:
    return {"stamp": rosbag_reader.make_stamp(t), "frame_id": frame}


def _frame_msg(kind: str, img: np.ndarray, t: float, frame: str):
    if kind == "png":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        return CIMG_T, {"header": _header(t, frame), "format": "png",
                        "data": buf.getvalue()}
    if kind == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        return CIMG_T, {"header": _header(t, frame), "format": "jpeg",
                        "data": buf.getvalue()}
    if kind == "bgr8":
        data = np.ascontiguousarray(img[..., ::-1]).tobytes()
        enc, step = "bgr8", 3 * W
    else:
        data = img[..., 0].tobytes()
        enc, step = "mono8", W
    return IMG_T, {"header": _header(t, frame), "height": H, "width": W,
                   "encoding": enc, "is_bigendian": 0, "step": step,
                   "data": data}


def _camera_info(t: float) -> bytes:
    return rosbag_reader.encode({
        "header": _header(t, "camera0_optical"), "height": H, "width": W,
        "distortion_model": "plumb_bob", "d": [0.01, -0.002, 0.0, 0.0, 0.0],
        "k": [20.0, 0, 8.0, 0, 21.0, 6.0, 0, 0, 1],
        "r": [1.0, 0, 0, 0, 1, 0, 0, 0, 1],
        "p": [20.0, 0, 8, 0, 0, 21, 6, 0, 0, 0, 1, 0],
        "binning_x": 0, "binning_y": 0,
        "roi": {"x_offset": 0, "y_offset": 0, "height": 0, "width": 0,
                "do_rectify": 0}}, INFO_T)


def bag_messages(seed: int = 0):
    """(messages, the frames of each topic): 7 poses bracketing 5 frames a
    topic (frame 2 repeats frame 1: the extractor drops it)."""
    rng = np.random.default_rng(seed)
    msgs, frames = [], {}
    for k in range(N_FRAMES + 2):
        t = 10.0 + k
        q = Rotation.from_rotvec(rng.normal(0, 0.3, 3)).as_quat()
        msgs.append((POSE_TOPIC, POSE_T, int(t * 1e9), rosbag_reader.encode({
            "header": _header(t, "map"),
            "pose": {"pose": {
                "position": dict(zip("xyz", rng.normal(0, 2, 3).tolist())),
                "orientation": dict(zip("xyzw", q.tolist()))},
                "covariance": [0.0] * 36}}, POSE_T)))
    for c, (topic, kind) in enumerate(TOPICS.items()):
        frames[topic] = []
        for k in range(N_FRAMES):
            t = 10.3 + k + 0.1 * c
            if k == 2:
                img = frames[topic][-1]
            else:
                img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
                if kind == "mono8":
                    img = np.repeat(img[..., :1], 3, axis=-1)
            frames[topic].append(img)
            typ, msg = _frame_msg(kind, img, t, f"camera{c}_optical")
            msgs.append((topic, typ, int(t * 1e9),
                         rosbag_reader.encode(msg, typ)))
    msgs.append(("/sensing/camera/camera0/camera_info", INFO_T,
                 int(10.0 * 1e9), _camera_info(10.0)))
    return msgs, frames


CALIB = {"base_link": {"sensor_kit_base_link": {
    "x": 0.9, "y": 0.1, "z": 2.0, "roll": -0.01, "pitch": 0.02,
    "yaw": 0.03}},
    "sensor_kit_base_link": {
        f"camera{c}": {"x": 0.2 * c, "y": -0.1, "z": 0.05 * c,
                       "roll": -1.57 + 0.1 * c, "pitch": 0.01 * c,
                       "yaw": -1.57 + 0.3 * c} for c in range(4)}}


class _Stop(Exception):
    pass


def _parser_flags(monkeypatch, run) -> dict:
    """The arguments of the parser ``run()`` parses with."""
    caught = {}

    def parse_args(self, args=None, namespace=None):
        caught["p"] = self
        raise _Stop

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Stop):
            run()
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     a.required, type(a).__name__)
            for a in caught["p"]._actions if a.dest != "help"}


@pytest.mark.parametrize("name,port", [
    ("extract_images_from_rosbag", extract_images_from_rosbag),
    ("interpolate", interpolate),
    ("modified_offset_by_particles_log", modified_offset_by_particles_log)])
def test_flags_match_the_script(name, port, monkeypatch):
    monkeypatch.syspath_prepend(str(SCRIPTS))
    want = _parser_flags(monkeypatch, _script(name).main)
    assert _parser_flags(monkeypatch, lambda: port.main([])) == want


def test_cdr_bytes_equal_jax(jbag):
    msgs, _ = bag_messages()
    for _, typ, _, data in msgs:
        msg = rosbag_reader.decode(data, typ)
        assert msg == jbag.decode(data, typ)
        assert rosbag_reader.encode(msg, typ) == jbag.encode(msg, typ) == data


@pytest.mark.parametrize("fmt", ["db3", "mcap", "mcap_zstd"])
def test_bag_files_equal_jax(fmt, tmp_path, jbag):
    """The same records make the same file bytes in both modules, and
    each module reads the other's file to the same records."""
    msgs, _ = bag_messages()
    mine, theirs = tmp_path / f"port.{fmt[:4]}", tmp_path / f"jax.{fmt[:4]}"
    if fmt == "db3":
        rosbag_reader.write_bag(str(mine), msgs)
        jbag.write_bag(str(theirs), msgs)
    else:
        comp = "zstd" if fmt == "mcap_zstd" else ""
        rosbag_reader.write_bag_mcap(str(mine), msgs, compression=comp)
        jbag.write_bag_mcap(str(theirs), msgs, compression=comp)
    assert mine.read_bytes() == theirs.read_bytes()
    ordered = sorted(msgs, key=lambda m: m[2])
    assert list(rosbag_reader.read_bag_any(str(theirs))) == ordered
    assert list(jbag.read_bag_any(str(mine))) == ordered
    topic = POSE_TOPIC
    assert (list(rosbag_reader.read_bag_any(str(theirs), [topic]))
            == [m for m in ordered if m[0] == topic])


def _extract(tmp_path, monkeypatch, skip: int = 1):
    """Both extractors on one bag; returns (port dir, JAX dir, frames)."""
    msgs, frames = bag_messages()
    bag = tmp_path / "bag.db3"
    rosbag_reader.write_bag(str(bag), msgs)
    calib = tmp_path / "calib.yaml"
    calib.write_text(yaml.safe_dump(CALIB))
    args = [str(bag), str(calib), None, "--image_topics", *TOPICS,
            "--skip", str(skip)]
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    _run(extract_images_from_rosbag.main,
         [a if a else str(out_t) for a in args])
    _run(_script("extract_images_from_rosbag").main,
         [a if a else str(out_j) for a in args], monkeypatch,
         "extract_images_from_rosbag")
    return out_t, out_j, frames


def _decoded(path: pathlib.Path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_extraction_equals_jax(tmp_path, monkeypatch):
    out_t, out_j, frames = _extract(tmp_path, monkeypatch)
    # the same files, the same texts
    files_t = sorted(p.relative_to(out_t) for p in out_t.rglob("*")
                     if p.is_file())
    files_j = sorted(p.relative_to(out_j) for p in out_j.rglob("*")
                     if p.is_file())
    assert files_t == files_j
    for rel in files_t:
        if rel.suffix == ".png":
            np.testing.assert_array_equal(_decoded(out_t / rel),
                                          _decoded(out_j / rel))
        elif rel.suffix == ".tsv":
            assert (out_t / rel).read_text() == (out_j / rel).read_text()
    assert (yaml.safe_load((out_t / "camera_info.yaml").read_text())
            == yaml.safe_load((out_j / "camera_info.yaml").read_text()))
    # every topic kept its frames in the pose window, less the repeat
    merged = sorted((out_t / "images").glob("*.png"))
    assert len(merged) == 4 * (N_FRAMES - 1)
    rows = (out_t / "pose.tsv").read_text().splitlines()
    assert len(rows) == 1 + len(merged)
    at = 0
    for topic, kind in TOPICS.items():
        kept = [f for k, f in enumerate(frames[topic]) if k != 2]
        for img in kept:
            got = _decoded(merged[at])
            if kind == "jpeg":
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=90)
                img = _decoded(buf)
            np.testing.assert_array_equal(got, img)
            at += 1


def test_extraction_skip_equals_jax(tmp_path, monkeypatch):
    out_t, out_j, _ = _extract(tmp_path, monkeypatch, skip=2)
    assert (out_t / "pose.tsv").read_text() == (out_j / "pose.tsv").read_text()
    assert (len(list((out_t / "images").glob("*.png")))
            == len(list((out_j / "images").glob("*.png"))) > 0)


def test_interpolate_equals_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    rows = ["timestamp\tx\ty\tz\tqx\tqy\tqz\tqw"]
    for k in range(6):
        q = Rotation.from_rotvec(rng.normal(0, 1, 3)).as_quat()
        rows.append("\t".join(f"{v:.9f}" for v in (
            10.0 + k, *rng.normal(0, 1, 3), *q)))
    (tmp_path / "p.tsv").write_text("\n".join(rows) + "\n")
    (tmp_path / "q.txt").write_text("9.5 10.25 12.5 12.5004 15.0 16\n")
    args = [str(tmp_path / "p.tsv"), str(tmp_path / "q.txt"), "--out"]
    _run(interpolate.main, [*args, str(tmp_path / "t.tsv")])
    _run(_script("interpolate").main, [*args, str(tmp_path / "j.tsv")],
         monkeypatch, "interpolate")
    assert ((tmp_path / "t.tsv").read_text()
            == (tmp_path / "j.tsv").read_text())


def _kd_camera_info(path: pathlib.Path) -> None:
    path.write_text(yaml.safe_dump({
        "K": [20.0, 0.0, 8.0, 0.0, 21.0, 6.0, 0.0, 0.0, 1.0],
        "D": [0.01, -0.002, 0.0, 0.0, 0.0]}))


def test_convert_equals_jax(tmp_path, monkeypatch):
    out_t, out_j, _ = _extract(tmp_path, monkeypatch)
    for d in (out_t, out_j):
        _kd_camera_info(d / "camera_info.yaml")
    data = convert_pose_tsv_to_f2_format.convert(str(out_t / "pose.tsv"))
    jdata = _script("convert_pose_tsv_to_f2_format").convert(
        str(out_j / "pose.tsv"))
    np.testing.assert_array_equal(data, jdata)
    text = (out_t / "cams_meta.tsv").read_text()
    assert text == (out_j / "cams_meta.tsv").read_text()
    assert len(text.splitlines()) == 1 + 4 * (N_FRAMES - 1)
    # main, as a user runs it
    assert "wrote cams_meta.tsv for 16 poses" in _run(
        convert_pose_tsv_to_f2_format.main, [str(out_t / "pose.tsv")])


def test_fact8_extractor_output_is_not_converter_input(tmp_path,
                                                       monkeypatch):
    """ROADMAP fact 8: the extractor writes camera_info.yaml in the
    camera_matrix / distortion_coefficients form; the converter reads
    only K and D, so the chain stops at KeyError 'D' in both packages
    until the user writes a K / D camera_info.yaml."""
    out_t, out_j, _ = _extract(tmp_path, monkeypatch)
    info = yaml.safe_load((out_j / "camera_info.yaml").read_text())
    assert "camera_matrix" in info and "D" not in info
    with pytest.raises(KeyError, match="'D'"):
        _script("convert_pose_tsv_to_f2_format").convert(
            str(out_j / "pose.tsv"))
    with pytest.raises(KeyError, match="'D'"):
        convert_pose_tsv_to_f2_format.convert(str(out_t / "pose.tsv"))


PARAMS_TEXT = """\
/**:
  ros__parameters:
    base_frame: base_link
    particle_num: 100
    noise_position_x: 0.05
    offset_position_x: 0.5
    offset_position_y: -0.1
    offset_position_z: 1.2
    offset_rotation_w: 0.9961946980917455
    offset_rotation_x: 0.0
    offset_rotation_y: 0.08715574274765817
    offset_rotation_z: 0.0
    topics: [/sensing/camera/camera0/image_rect_color, /localization/pose]
"""


def _particles(path: pathlib.Path, seed: int) -> None:
    rng = np.random.default_rng(seed)
    cols = particles_log.POSE_COLS + ["weight"]
    lines = ["\t".join(cols)]
    for k in range(6):
        r = Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
        pose = np.concatenate([r, rng.normal(0, 0.1, (3, 1))], axis=1)
        lines.append("\t".join(f"{v:.6f}" for v in pose.ravel())
                     + f"\t{rng.random():.6f}")
    path.write_text("\n".join(lines) + "\n")


def test_particles_log_equals_jax(tmp_path):
    _particles(tmp_path / "p.tsv", 1)
    jpl = _script("analyze_particles_log")
    assert particles_log.POSE_COLS == jpl.POSE_COLS
    for a, b in zip(particles_log.load_particles(tmp_path / "p.tsv"),
                    jpl.load_particles(tmp_path / "p.tsv")):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "bad.tsv").write_text("a\tb\n1\t2\n")
    with pytest.raises(ValueError, match="unexpected header"):
        particles_log.load_particles(tmp_path / "bad.tsv")


@pytest.mark.parametrize("write", [False, True])
def test_modified_offset_equals_jax(write, tmp_path, monkeypatch):
    """An Autoware parameter file (top key ``/**``): the same report, and
    the same file under PyYAML, its keys in the input's order."""
    _particles(tmp_path / "p.tsv", 2)
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "params.yaml").write_text(PARAMS_TEXT)
    flag = ["--write"] if write else []
    got = _run(modified_offset_by_particles_log.main,
               [str(tmp_path / "p.tsv"), "--params_yaml",
                str(tmp_path / "t" / "params.yaml"), *flag])
    monkeypatch.syspath_prepend(str(SCRIPTS))
    want = _run(_script("modified_offset_by_particles_log").main,
                [str(tmp_path / "p.tsv"), "--params_yaml",
                 str(tmp_path / "j" / "params.yaml"), *flag], monkeypatch,
                "modified_offset_by_particles_log")
    assert got.replace("/t/", "/j/") == want
    t = yaml.safe_load((tmp_path / "t" / "params.yaml").read_text())
    j = yaml.safe_load((tmp_path / "j" / "params.yaml").read_text())
    assert t.keys() == j.keys() == {"/**"}
    tp, jp = t["/**"]["ros__parameters"], j["/**"]["ros__parameters"]
    assert list(tp) == list(jp) == list(
        yaml.safe_load(PARAMS_TEXT)["/**"]["ros__parameters"])
    assert tp.keys() == jp.keys()
    for k in tp:
        if isinstance(tp[k], float):
            assert tp[k] == pytest.approx(jp[k], abs=1e-12), k
        else:
            assert tp[k] == jp[k], k
    if write:
        assert tp["offset_position_x"] != 0.5
    else:
        assert (tmp_path / "t" / "params.yaml").read_text() == PARAMS_TEXT


@pytest.mark.parametrize("key", ["/**", "/sensing/camera0", "a b", "it's",
                                 "1", "-x", "ros__parameters"])
def test_yaml_io_keys_against_pyyaml(key):
    """Autoware's ``/**`` and keys YAML must quote: the port writes each
    so that PyYAML reads it back, and reads PyYAML's text of a ``/**``
    parameter file."""
    from f2nerf_tpu_torch.core import yaml_io

    data = {key: {"ros__parameters": {"offset_position_x": 0.5,
                                      "name": "/base_link", "n": 3}}}
    text = yaml_io.dumps(data)
    assert yaml.safe_load(text) == data
    assert yaml_io.loads(text) == data
    if key == "/**":
        assert text.startswith("/**:\n")
        assert yaml_io.loads(yaml.safe_dump(data, sort_keys=False)) == data


def test_modified_offset_without_params(tmp_path):
    """Without a params file the printed block is the delta itself."""
    _particles(tmp_path / "p.tsv", 4)
    text = _run(modified_offset_by_particles_log.main,
                [str(tmp_path / "p.tsv")])
    poses, weights = particles_log.load_particles(tmp_path / "p.tsv")
    best = int(weights.argmax())
    diff = poses[best][:3, 3] - poses[0][:3, 3]
    assert f"best index: {best}" in text
    assert f"    offset_position_x: {diff[0]:.6f}" in text


# -- without jax, PIL or yaml -------------------------------------------------

_BLOCKED = r"""
import importlib.abc, json, runpy, sys
BLOCKED = ("yaml", "PIL", "jax", "f2nerf_tpu", "matplotlib", "zstandard",
           "lz4")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
work = sys.argv[2]
rcs = {}

def tool(name, *argv):
    sys.argv = [name, *[a.replace("@", work) for a in argv]]
    try:
        runpy.run_module("f2nerf_tpu_torch.tools." + name,
                         run_name="__main__")
        rcs[name] = 0
    except SystemExit as e:
        rcs[name] = e.code or 0

tool("extract_images_from_rosbag", "@/" + sys.argv[4], "@/calib.yaml",
     "@/out", "--image_topics", *json.loads(sys.argv[3]))
with open(work + "/out/camera_info.yaml", "w") as f:
    f.write("K: [20.0, 0.0, 8.0, 0.0, 21.0, 6.0, 0.0, 0.0, 1.0]\n"
            "D: [0.01, -0.002, 0.0, 0.0, 0.0]\n")
tool("convert_pose_tsv_to_f2_format", "@/out/pose.tsv")
tool("modified_offset_by_particles_log", "@/p.tsv", "--params_yaml",
     "@/params.yaml", "--write")
print(json.dumps({"rcs": rcs, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)}))
"""


def _write_bag(path: pathlib.Path, kind: str, msgs: list) -> None:
    """``msgs`` in a ``.db3`` bag or an mcap bag with one zstd or LZ4
    chunk."""
    if kind == "db3":
        rosbag_reader.write_bag(str(path), msgs)
    elif kind == "zstd":
        rosbag_reader.write_bag_mcap(str(path), msgs, compression="zstd")
    else:
        write_lz4_bag(path, msgs)


def _blocked_chain(work: pathlib.Path, kind: str) -> dict:
    """The bag of ``bag_messages()`` as ``kind`` -> extraction -> the
    converter -> the offset tool, in a process where ``_BLOCKED``'s
    modules raise on import."""
    msgs, _ = bag_messages()
    bag = "bag.db3" if kind == "db3" else "bag.mcap"
    _write_bag(work / bag, kind, msgs)
    (work / "calib.yaml").write_text(yaml.safe_dump(CALIB))
    (work / "params.yaml").write_text(PARAMS_TEXT)
    _particles(work / "p.tsv", 5)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(ROOT), str(work),
         json.dumps(list(TOPICS)), bag], capture_output=True, text=True,
        timeout=300, cwd=work, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert set(res["rcs"].values()) == {0}, res
    return res


def test_tools_run_without_jax_pil_yaml(tmp_path):
    _blocked_chain(tmp_path, "db3")
    assert len(list((tmp_path / "out" / "images").glob("*.png"))) == 16
    assert (tmp_path / "out" / "cams_meta.tsv").is_file()
    written = yaml.safe_load((tmp_path / "params.yaml").read_text())
    assert written["/**"]["ros__parameters"]["offset_position_x"] != 0.5


@pytest.fixture(scope="module")
def compressed_chains(tmp_path_factory) -> dict:
    """{kind: work directory} of ``_blocked_chain`` on the zstd- and the
    LZ4-chunked mcap bag."""
    out = {}
    for kind in ("zstd", "lz4"):
        out[kind] = tmp_path_factory.mktemp(f"chain_{kind}")
        _blocked_chain(out[kind], kind)
    return out


def _port_chain(work: pathlib.Path) -> None:
    """The port's extractor and converter, in this process, on the
    ``.db3`` bag of ``bag_messages()`` (the ``K`` / ``D`` camera file as
    ``_BLOCKED`` writes it)."""
    msgs, _ = bag_messages()
    rosbag_reader.write_bag(str(work / "bag.db3"), msgs)
    (work / "calib.yaml").write_text(yaml.safe_dump(CALIB))
    _run(extract_images_from_rosbag.main,
         [str(work / "bag.db3"), str(work / "calib.yaml"), str(work / "out"),
          "--image_topics", *TOPICS])
    (work / "out" / "camera_info.yaml").write_text(
        "K: [20.0, 0.0, 8.0, 0.0, 21.0, 6.0, 0.0, 0.0, 1.0]\n"
        "D: [0.01, -0.002, 0.0, 0.0, 0.0]\n")
    _run(convert_pose_tsv_to_f2_format.main, [str(work / "out" / "pose.tsv")])


def _same_outputs(a: pathlib.Path, b: pathlib.Path,
                  texts=("pose.tsv", "cams_meta.tsv")) -> None:
    """The same images (decoded, bitwise) and ``texts``."""
    ia = sorted(p.name for p in (a / "images").glob("*.png"))
    assert ia == sorted(p.name for p in (b / "images").glob("*.png"))
    assert len(ia) == 16
    for name in ia:
        np.testing.assert_array_equal(_decoded(a / "images" / name),
                                      _decoded(b / "images" / name))
    for name in texts:
        assert (a / name).read_text() == (b / name).read_text(), name


@pytest.mark.parametrize("kind", ["zstd", "lz4"])
def test_tools_read_compressed_bags_without_modules(kind, compressed_chains,
                                                    tmp_path):
    """With ``zstandard`` and ``lz4`` unimportable (beside jax, PIL and
    yaml), the tools read a zstd- or LZ4-chunked mcap bag to the images,
    ``pose.tsv`` and ``cams_meta.tsv`` of the ``.db3`` bag of the same
    records."""
    _port_chain(tmp_path)
    _same_outputs(compressed_chains[kind] / "out", tmp_path / "out")


def test_jax_and_port_extract_the_same_zstd_bag(compressed_chains, tmp_path,
                                                monkeypatch):
    """The JAX extractor (with ``zstandard``) and the port's (without it)
    on one zstd-chunked mcap bag: the same images, bitwise, and the same
    ``pose.tsv``."""
    work = compressed_chains["zstd"]
    _run(_script("extract_images_from_rosbag").main,
         [str(work / "bag.mcap"), str(work / "calib.yaml"),
          str(tmp_path / "jax"), "--image_topics", *TOPICS], monkeypatch,
         "extract_images_from_rosbag")
    _same_outputs(work / "out", tmp_path / "jax", texts=("pose.tsv",))


FLOW_YAML = {
    "list_over_lines": "data: [1000.0, 0.0, 960.0,\n"
                       "       0.0, 1000.0, 540.0,\n"
                       "       0.0, 0.0, 1.0]\nnext: 1\n",
    "list_closing_alone": "a:\n  b: [1, 2,\n    3\n  ]\n  c: x\n",
    "list_with_comments": "a: [1, # one\n\n    'two, 2', \"3\",  # three\n"
                          "  4.5e+00, .5, 0.]\n",
    "list_unindented": "a: [1,\n2]\n",
    "flow_mapping": "calib: {fx: 1.0, fy: 2.0, 'c x': 3, name: cam, n: ~}\n",
    "flow_mapping_over_lines": "a:\n  calib: {fx: 1.4017e+03,\n"
                               "    fy: 1.4e+03,\n    flag: yes}\n",
    "flow_mapping_empty": "a: {}\nb: []\nc: {b: 1}\n",
    "block_sequence_of_lists": "rows:\n  - [1, 0, 0]\n  - [0, 1,\n"
                               "     0]\n  - 5\n  - {x: 1}\nk: 2\n",
    "camera_info": """\
image_width: 1920
image_height: 1080
camera_name: camera0
camera_matrix:
  rows: 3
  cols: 3
  data: [1400.0, 0.0, 960.0,
         0.0, 1401.7, 540.0,
         0.0, 0.0, 1.0]
distortion_model: plumb_bob
distortion_coefficients:
  rows: 1
  cols: 5
  data: [-0.05, 0.01, 0.0, 0.0, 0.0]
rectification_matrix:
  rows: 3
  cols: 3
  data: [1., 0., 0.,
         0., 1., 0.,
         0., 0., 1.]
projection_matrix:
  rows: 3
  cols: 4
  data: [1400.0, 0.0, 960.0, 0.0,
         0.0, 1401.7, 540.0, 0.0,
         0.0, 0.0, 1.0, 0.0]
K: [1400.0, 0.0, 960.0,
    0.0, 1401.7, 540.0,
    0.0, 0.0, 1.0]
D: [-0.05, 0.01, 0.0, 0.0, 0.0]
"""}


@pytest.mark.parametrize("name", sorted(FLOW_YAML))
def test_yaml_io_flow_collections_against_pyyaml(name):
    """Flow lists and flow mappings of scalars, on one line or over
    several, under keys and as block-sequence items: what PyYAML loads."""
    from f2nerf_tpu_torch.core import yaml_io

    text = FLOW_YAML[name]
    assert yaml_io.loads(text, block_sequences=True) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, [2,\n  3]]\n", "a: {b: {c: 1}}\n", "a: {b: [1]}\n",
    "a: [x\n  y]\n", "a: [1, 'x\n  y']\n", "a: [1, &x 2]\n",
    "a: {b: !!int 1}\n", "a: [1, 2\nb: 3\n", "a: [1,\n  2] x\n",
    "a: {b}\n", "a: {b: 1, b: 2}\n", "a: [1,,2]\n", "a: [*x]\n",
    "a:\n  - [1,\n  - 2]\n"])
def test_yaml_io_flow_outside_the_subset_raises(text):
    """Nested flow collections, multi-line strings, anchors, aliases,
    tags, unclosed collections and keys without values still raise,
    naming the line."""
    from f2nerf_tpu_torch.core import yaml_io

    with pytest.raises(ValueError, match="line"):
        yaml_io.loads(text, block_sequences=True)


def test_multi_line_camera_info_converts_as_jax(tmp_path, monkeypatch):
    """A hand-edited ``camera_info.yaml`` whose matrices span three lines
    gives the JAX converter's ``cams_meta.tsv``."""
    out_t, out_j, _ = _extract(tmp_path, monkeypatch)
    for d in (out_t, out_j):
        (d / "camera_info.yaml").write_text(FLOW_YAML["camera_info"])
    convert_pose_tsv_to_f2_format.convert(str(out_t / "pose.tsv"))
    _script("convert_pose_tsv_to_f2_format").convert(str(out_j / "pose.tsv"))
    text = (out_t / "cams_meta.tsv").read_text()
    assert text == (out_j / "cams_meta.tsv").read_text()
    assert "\t1401.7\t" in text
