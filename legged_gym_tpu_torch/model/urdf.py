"""Host-side URDF parser.

Replaces the reference's use of Isaac Gym's C++ asset importer
(``gym.load_asset``, legged_gym/envs/base/legged_robot.py:673).
Runs once at init on the host; produces plain Python/numpy structures that
model/robot.py compiles into the static RobotModel pytree.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np


def _floats(s, default=None):
    if s is None:
        return default
    return [float(x) for x in s.replace(",", " ").split()]


def rpy_to_matrix(rpy):
    """URDF fixed-axis roll-pitch-yaw to rotation matrix: R = Rz(y)Ry(p)Rx(r)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclasses.dataclass
class Geom:
    kind: str              # 'sphere' | 'box' | 'cylinder' | 'capsule' | 'mesh'
    params: dict
    pos: np.ndarray        # offset in link frame
    rot: np.ndarray        # 3x3 rotation in link frame


@dataclasses.dataclass
class Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # 3x3 inertia about the COM, expressed in the link frame (already rotated
    # by the inertial-origin rpy).
    inertia: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((3, 3)))
    collisions: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Joint:
    name: str
    kind: str              # 'revolute' | 'continuous' | 'prismatic' | 'fixed'
    parent: str
    child: str
    pos: np.ndarray
    rot: np.ndarray
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0
    damping: float = 0.0
    friction: float = 0.0
    dont_collapse: bool = False


@dataclasses.dataclass
class Urdf:
    name: str
    links: dict            # name -> Link
    joints: list           # list[Joint] in document order
    root_link: str


def parse_urdf(path: str) -> Urdf:
    tree = ET.parse(os.path.expanduser(path))
    robot = tree.getroot()

    links = {}
    for el in robot.findall("link"):
        link = Link(name=el.get("name"))
        inertial = el.find("inertial")
        if inertial is not None:
            origin = inertial.find("origin")
            xyz = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
            rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
            R = rpy_to_matrix(rpy)
            link.mass = float(inertial.find("mass").get("value"))
            link.com = np.array(xyz)
            it = inertial.find("inertia")
            I = np.array([
                [float(it.get("ixx")), float(it.get("ixy")), float(it.get("ixz"))],
                [float(it.get("ixy")), float(it.get("iyy")), float(it.get("iyz"))],
                [float(it.get("ixz")), float(it.get("iyz")), float(it.get("izz"))],
            ])
            link.inertia = R @ I @ R.T
        for col in el.findall("collision"):
            origin = col.find("origin")
            xyz = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
            rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
            geom_el = col.find("geometry")
            for g in geom_el:
                if g.tag == "sphere":
                    params = {"radius": float(g.get("radius"))}
                elif g.tag == "box":
                    params = {"size": np.array(_floats(g.get("size")))}
                elif g.tag in ("cylinder", "capsule"):
                    params = {"radius": float(g.get("radius")),
                              "length": float(g.get("length"))}
                elif g.tag == "mesh":
                    params = {"filename": g.get("filename")}
                else:
                    continue
                link.collisions.append(
                    Geom(kind=g.tag, params=params, pos=np.array(xyz),
                         rot=rpy_to_matrix(rpy)))
        links[link.name] = link

    joints = []
    children = set()
    for el in robot.findall("joint"):
        origin = el.find("origin")
        xyz = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
        rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
        axis_el = el.find("axis")
        axis = np.array(_floats(axis_el.get("xyz") if axis_el is not None else None,
                                [1, 0, 0]))
        n = np.linalg.norm(axis)
        if n > 0:
            axis = axis / n
        j = Joint(
            name=el.get("name"), kind=el.get("type"),
            parent=el.find("parent").get("link"),
            child=el.find("child").get("link"),
            pos=np.array(xyz), rot=rpy_to_matrix(rpy), axis=axis,
            dont_collapse=(el.get("dont_collapse", "false").lower() == "true"),
        )
        limit = el.find("limit")
        has_range = False
        if limit is not None:
            # key the unlimited fallback on attribute ABSENCE, not on the
            # parsed zeros: an explicit <limit lower="0" upper="0"/> is an
            # intentionally locked joint and must stay [0, 0]
            has_range = (limit.get("lower") is not None
                         or limit.get("upper") is not None)
            j.lower = float(limit.get("lower", "0"))
            j.upper = float(limit.get("upper", "0"))
            j.effort = float(limit.get("effort", "0"))
            j.velocity = float(limit.get("velocity", "0"))
        if j.kind == "continuous" or not has_range:
            # no position range declared (ANYmal's URDF: <limit effort
            # velocity/> only) = unlimited, matching Isaac's importer
            # (hasLimits=false -> +-inf DOF props; the reference's
            # soft-rescale and target clip then no-op). Parsing the
            # absent range as [0, 0] would pin every joint to zero —
            # both the joint-limit spring and the hard projection
            # (integrator.py) key off these bounds.
            j.lower, j.upper = -np.pi * 1e6, np.pi * 1e6
        dyn = el.find("dynamics")
        if dyn is not None:
            j.damping = float(dyn.get("damping", "0"))
            j.friction = float(dyn.get("friction", "0"))
        joints.append(j)
        children.add(j.child)

    roots = [name for name in links if name not in children]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, got {roots}")
    return Urdf(name=robot.get("name"), links=links, joints=joints,
                root_link=roots[0])
