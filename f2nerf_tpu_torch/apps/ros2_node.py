"""ROS2 relay node (port of ``f2nerf_tpu/apps/ros2_node.py``): the
reference's NerfBasedLocalizer topics and services over the port's
:class:`~f2nerf_tpu_torch.apps.serve.LocalizerService`.

Reference ``ros2/src/ros2-f2-nerf/src/nerf_based_localizer.cpp``:

* subscribes ``initial_pose_with_covariance``
  (geometry_msgs/PoseWithCovarianceStamped, :44-48) and ``image``
  (sensor_msgs/Image, :49-54),
* publishes ``nerf_pose`` (PoseStamped, :56), ``nerf_pose_with_covariance``
  (PoseWithCovarianceStamped with the output_covariance diagonal,
  :141-153), ``nerf_score`` (std_msgs/Float32, :60), ``nerf_image``
  (Image, :61),
* serves ``nerf_service`` (tier4_localization_msgs/
  PoseWithCovarianceStamped, :65-69, when that package is installed) and
  ``trigger_node_srv`` (std_srvs/SetBool activation gate, :70-74).

The localization itself (score-adaptive particle noise, particle TSVs,
pose fusion) lives in the service; this module only maps ROS messages
to its dict protocol. ``rclpy`` is import-gated: without it ``main``
returns 1, and everything else runs against stub message modules
installed in ``sys.modules`` before this module is imported (or
reloaded).

The frame goes to the service as the float32 array itself, not as a
nested list as over TCP (``serve._localize`` starts with
``np.asarray(image, dtype=np.float32)``, which takes either and gives
the same values); the service's ``"rendered"`` reply, a list, is turned
back into an array once.

Simplifications kept from the JAX node: the tf2 base_link <-> camera
extrinsics (:237-246) are one fixed ``camera_to_base_link`` 4x4; the
image queue is one deep and the node localizes in the image callback
(:106-160).

Run (inside a ROS2 workspace):
``python -m f2nerf_tpu_torch.apps.ros2_node <run_dir> [--device cpu]``;
the run directory is what ``apps.serve`` reads.
"""

from __future__ import annotations

import numpy as np

try:  # import-gated: rclpy exists only inside a ROS2 workspace
    import rclpy
    from rclpy.node import Node
    HAVE_RCLPY = True
except ImportError:
    rclpy = None
    Node = object
    HAVE_RCLPY = False


# -- msg <-> numpy conversion ------------------------------------------------

def pose_msg_to_matrix(position, orientation) -> np.ndarray:
    """geometry_msgs/Pose -> 4x4 homogeneous world pose. ROS quaternions
    carry (x, y, z, w) fields and go to ``quat_xyzw_to_matrix`` in that
    order."""
    from f2nerf_tpu_torch.localize.localizer import quat_xyzw_to_matrix

    quat_xyzw = np.array([orientation.x, orientation.y, orientation.z,
                          orientation.w], dtype=np.float64)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_xyzw_to_matrix(quat_xyzw)
    m[:3, 3] = [position.x, position.y, position.z]
    return m


def matrix_to_pose_msg(pose_cls, m: np.ndarray):
    """4x4 (or 3x4) world pose -> a geometry_msgs/Pose instance of
    ``pose_cls``."""
    from f2nerf_tpu_torch.localize.localizer import matrix_to_quat_xyzw

    msg = pose_cls()
    quat_xyzw = matrix_to_quat_xyzw(np.asarray(m)[:3, :3])
    msg.orientation.x = float(quat_xyzw[0])
    msg.orientation.y = float(quat_xyzw[1])
    msg.orientation.z = float(quat_xyzw[2])
    msg.orientation.w = float(quat_xyzw[3])
    msg.position.x = float(m[0, 3])
    msg.position.y = float(m[1, 3])
    msg.position.z = float(m[2, 3])
    return msg


def image_msg_to_array(msg, crop_rows: int = 0) -> np.ndarray:
    """sensor_msgs/Image -> float32 [H, W, 3] in [0, 1], RGB: BGR flipped
    to RGB, cropped to the top ``crop_rows`` rows when set
    (nerf_based_localizer.cpp:225-235)."""
    h, w = int(msg.height), int(msg.width)
    buf = np.frombuffer(bytes(msg.data), dtype=np.uint8)
    step = int(getattr(msg, "step", 0)) or w * 3
    img = buf.reshape(h, step)[:, : w * 3].reshape(h, w, 3)
    if msg.encoding in ("bgr8", "bgra8"):
        img = img[..., ::-1]
    elif msg.encoding not in ("rgb8", "rgba8"):
        raise ValueError(f"unsupported encoding {msg.encoding!r}")
    if crop_rows > 0:
        img = img[:crop_rows]
    return np.ascontiguousarray(img).astype(np.float32) / 255.0


def array_to_image_msg(image_cls, rgb: np.ndarray, frame_id: str, stamp):
    """float [H, W, 3] in [0, 1] -> sensor_msgs/Image (rgb8)."""
    msg = image_cls()
    arr = np.clip(np.asarray(rgb) * 255.0, 0, 255).astype(np.uint8)
    msg.height, msg.width = int(arr.shape[0]), int(arr.shape[1])
    msg.encoding = "rgb8"
    msg.step = msg.width * 3
    msg.data = arr.tobytes()
    msg.header.frame_id = frame_id
    msg.header.stamp = stamp
    return msg


def output_covariance_diag(cov: float) -> np.ndarray:
    """The reference's fixed diagonal: positions ``cov``, rotations
    ``cov * 10`` (nerf_based_localizer.cpp:146-152)."""
    out = np.zeros(36, dtype=np.float64)
    out[[0, 7, 14]] = cov
    out[[21, 28, 35]] = cov * 10
    return out


# -- the node ----------------------------------------------------------------

class NerfBasedLocalizerNode(Node):
    """The rclpy relay; construct only when rclpy (or a stub) imports."""

    def __init__(self, service, optimization_mode: int = 0,
                 particle_num: int = 100, output_covariance: float = 0.1,
                 map_frame: str = "map", crop_rows: int = 0,
                 camera_to_base_link: np.ndarray | None = None):
        from geometry_msgs.msg import (PoseStamped,
                                       PoseWithCovarianceStamped)
        from sensor_msgs.msg import Image
        from std_msgs.msg import Float32
        from std_srvs.srv import SetBool

        super().__init__("nerf_based_localizer")
        self.service = service  # apps.serve.LocalizerService
        self.optimization_mode = optimization_mode
        self.particle_num = particle_num
        self.output_covariance = output_covariance
        self.map_frame = map_frame
        self.crop_rows = crop_rows
        self.cam2base = camera_to_base_link
        self.is_activated = False
        self._have_pose = False
        self._image_cls = Image

        self.create_subscription(
            PoseWithCovarianceStamped, "initial_pose_with_covariance",
            self.callback_initial_pose, 10)
        self.create_subscription(Image, "image", self.callback_image, 1)
        self.pub_pose = self.create_publisher(PoseStamped, "nerf_pose", 10)
        self.pub_pose_cov = self.create_publisher(
            PoseWithCovarianceStamped, "nerf_pose_with_covariance", 10)
        self.pub_score = self.create_publisher(Float32, "nerf_score", 10)
        self.pub_image = self.create_publisher(Image, "nerf_image", 10)
        self.create_service(SetBool, "trigger_node_srv",
                            self.service_trigger_node)
        try:  # Autoware-only message package, optional
            from tier4_localization_msgs.srv import (
                PoseWithCovarianceStamped as T4Srv)
            self.create_service(T4Srv, "nerf_service", self.service_nerf)
        except ImportError:
            self.get_logger().info(
                "tier4_localization_msgs unavailable; nerf_service off")

    # -- callbacks ---------------------------------------------------------
    def callback_initial_pose(self, msg) -> None:
        pose = pose_msg_to_matrix(msg.pose.pose.position,
                                  msg.pose.pose.orientation)
        if self.cam2base is not None:
            pose = pose @ self.cam2base
        self.service.handle({"cmd": "init_pose", "pose": pose.tolist()})
        self._have_pose = True

    def callback_image(self, msg) -> None:
        if not self.is_activated:
            self.get_logger().error(
                "NerfBasedLocalizer is not activated in callback_image.")
            return
        if not self._have_pose:
            self.get_logger().error(
                "initial_pose_with_covariance is not received.")
            return
        resp = self.service.handle({
            "cmd": "localize",
            "image": image_msg_to_array(msg, self.crop_rows),
            "mode": self.optimization_mode,
            "particle_num": self.particle_num, "return_image": True})
        if not resp.get("ok"):
            self.get_logger().error(f"localize failed: {resp.get('error')}")
            return
        rendered = resp.get("rendered")
        self.publish_result(
            np.asarray(resp["pose"]), resp["score"],
            None if rendered is None else np.asarray(rendered, np.float32),
            msg.header.stamp)

    def publish_result(self, pose_world: np.ndarray, score: float,
                       rendered: np.ndarray | None, stamp) -> None:
        from geometry_msgs.msg import (Pose, PoseStamped,
                                       PoseWithCovarianceStamped)
        from std_msgs.msg import Float32

        if self.cam2base is not None:
            pose_world = pose_world @ np.linalg.inv(self.cam2base)
        ps = PoseStamped()
        ps.header.frame_id = self.map_frame
        ps.header.stamp = stamp
        ps.pose = matrix_to_pose_msg(Pose, pose_world)
        self.pub_pose.publish(ps)

        pc = PoseWithCovarianceStamped()
        pc.header.frame_id = self.map_frame
        pc.header.stamp = stamp
        pc.pose.pose = matrix_to_pose_msg(Pose, pose_world)
        pc.pose.covariance = output_covariance_diag(
            self.output_covariance).tolist()
        self.pub_pose_cov.publish(pc)

        f = Float32()
        f.data = float(score)
        self.pub_score.publish(f)
        if rendered is not None:
            self.pub_image.publish(array_to_image_msg(
                self._image_cls, rendered, self.map_frame, stamp))

    # -- services ----------------------------------------------------------
    def service_trigger_node(self, req, res):
        """SetBool activation gate (nerf_based_localizer.cpp:70-74); a new
        activation waits for a new initial pose (:86-93)."""
        self.is_activated = bool(req.data)
        if self.is_activated:
            self._have_pose = False
        res.success = True
        return res

    def service_nerf(self, req, res):
        """A new initial pose from a service request
        (nerf_based_localizer.cpp:171-199)."""
        self.callback_initial_pose(req.pose_with_covariance)
        res.success = True
        return res


def main(argv=None) -> int:
    if not HAVE_RCLPY:
        print("rclpy is not available in this environment; run inside a "
              "ROS2 workspace (see the module docstring for the topics)")
        return 1
    import argparse

    from f2nerf_tpu_torch.apps.serve import LocalizerService
    from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam

    ap = argparse.ArgumentParser()
    ap.add_argument("train_result_dir")
    ap.add_argument("--optimization_mode", type=int, default=0)
    ap.add_argument("--particle_num", type=int, default=100)
    ap.add_argument("--output_covariance", type=float, default=0.1)
    ap.add_argument("--resize_factor", type=int, default=8)
    ap.add_argument("--crop_rows", type=int, default=0)
    ap.add_argument("--save_particles_dir", default=None)
    ap.add_argument("--profile_dir", default=None,
                    help="write a Chrome trace of frames 10-14 here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    core = Localizer.from_checkpoint(
        args.train_result_dir,
        LocalizerParam(resize_factor=args.resize_factor),
        device=args.device)
    service = LocalizerService(core,
                               save_particles_dir=args.save_particles_dir,
                               profile_dir=args.profile_dir)
    rclpy.init()
    node = NerfBasedLocalizerNode(
        service, optimization_mode=args.optimization_mode,
        particle_num=args.particle_num,
        output_covariance=args.output_covariance,
        crop_rows=args.crop_rows)
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
