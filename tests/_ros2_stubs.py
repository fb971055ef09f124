"""Stand-ins for the ROS2 modules the relay node imports (``rclpy``,
``rclpy.node``, ``geometry_msgs.msg``, ``sensor_msgs.msg``,
``std_msgs.msg``, ``std_srvs.srv``), so that ``apps/ros2_node.py`` runs
outside a ROS2 workspace. Publishers record what they are given, the
logger keeps the errors, and ``rclpy.spin(node)`` hands the node to the
caller, which stands in for the topics and services.

Install them with ``mock.patch.dict(sys.modules, modules(spin))`` (or
``monkeypatch.setitem`` per entry) before the node module is imported or
reloaded: it gates ``rclpy`` at import time.
"""

from __future__ import annotations

import types


class Vec:
    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = x, y, z


class Quat:
    def __init__(self, x=0.0, y=0.0, z=0.0, w=1.0):
        self.x, self.y, self.z, self.w = x, y, z, w


class Header:
    def __init__(self):
        self.stamp, self.frame_id = 0, ""


class Pose:
    def __init__(self):
        self.position, self.orientation = Vec(), Quat()


class PoseStamped:
    def __init__(self):
        self.header, self.pose = Header(), Pose()


class PoseWithCovariance:
    def __init__(self):
        self.pose, self.covariance = Pose(), [0.0] * 36


class PoseWithCovarianceStamped:
    def __init__(self):
        self.header, self.pose = Header(), PoseWithCovariance()


class Image:
    def __init__(self):
        self.header = Header()
        self.height = self.width = self.step = 0
        self.encoding, self.data = "", b""


class Float32:
    def __init__(self):
        self.data = 0.0


class Publisher:
    def __init__(self, topic: str):
        self.topic, self.published = topic, []

    def publish(self, msg) -> None:
        self.published.append(msg)


class Logger:
    def __init__(self):
        self.errors = []

    def info(self, msg) -> None:
        pass

    def error(self, msg) -> None:
        self.errors.append(msg)


class Node:
    """``rclpy.node.Node``: publishers record, the logger keeps errors."""

    def __init__(self, name: str):
        self.name = name
        self._logger = Logger()

    def create_subscription(self, *args, **kwargs):
        return None

    def create_publisher(self, cls, topic, depth):
        return Publisher(topic)

    def create_service(self, *args, **kwargs):
        return None

    def get_logger(self) -> Logger:
        return self._logger

    def destroy_node(self) -> None:
        pass


def modules(spin) -> dict[str, types.ModuleType]:
    """The stub modules by name; ``rclpy.spin`` is ``spin``."""

    def module(name, **attrs):
        m = types.ModuleType(name)
        m.__dict__.update(attrs)
        return m

    return {
        "rclpy": module("rclpy", init=lambda: None, spin=spin,
                        shutdown=lambda: None),
        "rclpy.node": module("rclpy.node", Node=Node),
        "geometry_msgs": module("geometry_msgs"),
        "geometry_msgs.msg": module(
            "geometry_msgs.msg", Pose=Pose, PoseStamped=PoseStamped,
            PoseWithCovarianceStamped=PoseWithCovarianceStamped),
        "sensor_msgs": module("sensor_msgs"),
        "sensor_msgs.msg": module("sensor_msgs.msg", Image=Image),
        "std_msgs": module("std_msgs"),
        "std_msgs.msg": module("std_msgs.msg", Float32=Float32),
        "std_srvs": module("std_srvs"),
        "std_srvs.srv": module("std_srvs.srv", SetBool=types.SimpleNamespace)}
