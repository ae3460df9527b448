"""URDF -> static RobotModel compiler.

Replacement for Isaac Gym's C++ asset importer + rigid-body
registry (reference call sites: legged_robot.py:658-740). Runs once on the
host at init; the result is a pytree of small numpy arrays that the
physics closes over as compile-time constants.

Semantics mirrored from the reference:
- ``collapse_fixed_joints`` merges fixed-jointed links into their movable
  parent, EXCEPT joints marked ``dont_collapse="true"`` (the feet in
  go1.urdf) which stay separate *report bodies* (legged_robot_config.py:109).
- cylinders are treated as capsules (two end spheres), matching
  ``replace_cylinder_with_capsule`` (legged_robot_config.py:113).
- per-body mass randomization stays exact under merging: each original
  link contributes a 10-parameter spatial-inertia term that scales
  linearly with its mass scale, so per-env randomized inertias are a
  (n_orig -> n_link) linear map evaluated at reset.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.model.urdf import parse_urdf

MOVABLE = ("revolute", "continuous", "prismatic")


@dataclasses.dataclass(frozen=True)
class RobotModel:
    name: str
    # --- kinematic tree (links = bodies connected by movable joints) ---
    nq: int                      # number of dofs (movable joints)
    nl: int                      # number of links (nq + 1, link 0 = base)
    dof_names: tuple
    link_names: tuple
    link_parent: np.ndarray      # (nl,) int, parent link of link i (-1 for base)
    joint_pos: np.ndarray        # (nq, 3) tree transform: parent link -> joint frame
    joint_rot: np.ndarray        # (nq, 3, 3)
    joint_axis: np.ndarray       # (nq, 3) axis in child-link frame
    joint_is_prismatic: np.ndarray  # (nq,) bool
    # --- dof properties (from URDF <limit>/<dynamics>) ---
    dof_lower: np.ndarray
    dof_upper: np.ndarray
    dof_vel_limit: np.ndarray
    dof_effort: np.ndarray
    dof_damping: np.ndarray
    dof_friction: np.ndarray
    armature: np.ndarray
    # --- inertia contributions (per original URDF link, merged frame) ---
    # 10 params: [m, hx, hy, hz, Ixx, Ixy, Ixz, Iyy, Iyz, Izz] about the
    # owning link's origin, in the owning link's frame.
    n_orig: int
    orig_names: tuple
    contrib: np.ndarray          # (n_orig, 10)
    contrib_link: np.ndarray     # (n_orig,) owning link index
    orig_is_base: np.ndarray     # (n_orig,) bool — part of the base link
    # --- report bodies (contact-force granularity, Isaac rigid-body list) ---
    body_names: tuple
    body_link: np.ndarray        # (nb,) owning link
    body_pos: np.ndarray         # (nb, 3) frame offset in link frame
    body_rot: np.ndarray         # (nb, 3, 3)
    # --- collision points ---
    cp_link: np.ndarray          # (npt,) owning link
    cp_body: np.ndarray          # (npt,) report body for force accumulation
    cp_pos: np.ndarray           # (npt, 3) in link frame
    cp_radius: np.ndarray        # (npt,)
    total_mass: float

    @property
    def num_bodies(self):
        return len(self.body_names)

    def match_bodies(self, substr):
        """Indices of report bodies whose name contains substr (reference
        semantics: legged_robot.py:684-690)."""
        return [i for i, n in enumerate(self.body_names) if substr in n]

    def match_dofs(self, substr):
        return [i for i, n in enumerate(self.dof_names) if substr in n]


def _inertia_params(mass, com, inertia_com):
    """10-parameter spatial inertia about the frame origin."""
    c = np.asarray(com)
    h = mass * c
    # parallel axis: I_O = I_com + m ((c.c) 1 - c c^T)
    I_O = inertia_com + mass * (np.dot(c, c) * np.eye(3) - np.outer(c, c))
    return np.array([mass, h[0], h[1], h[2],
                     I_O[0, 0], I_O[0, 1], I_O[0, 2],
                     I_O[1, 1], I_O[1, 2], I_O[2, 2]])


def _geom_points(geom, min_size=0.005):
    """Collision geometry -> list of (offset, radius) spheres in link frame.

    sphere -> 1 point; box -> 8 corners (small radius, analogous to PhysX's
    contact_offset); cylinder/capsule -> 2 end spheres (capsule replacement,
    legged_robot_config.py:113). Tiny sensor boxes are skipped.
    """
    pts = []
    if geom.kind == "sphere":
        pts.append((geom.pos, geom.params["radius"]))
    elif geom.kind == "box":
        size = geom.params["size"]
        if np.all(size < min_size):
            return []
        hx, hy, hz = size / 2.0
        r = 0.0
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    local = np.array([sx * hx, sy * hy, sz * hz])
                    pts.append((geom.pos + geom.rot @ local, r))
    elif geom.kind in ("cylinder", "capsule"):
        r = geom.params["radius"]
        half = geom.params["length"] / 2.0
        for s in (-1, 1):
            local = np.array([0.0, 0.0, s * half])
            pts.append((geom.pos + geom.rot @ local, r))
    # meshes are ignored for collisions (reference robots use primitives
    # for collision; meshes are visual-only there).
    return pts


def compile_model(urdf_path, collapse_fixed_joints=True, armature=0.0,
                  keep_feet=True) -> RobotModel:
    u = parse_urdf(urdf_path)

    joints_by_child = {j.child: j for j in u.joints}
    children = {}
    for j in u.joints:
        children.setdefault(j.parent, []).append(j)

    # --- assign every original link to a dynamic link (movable subtree root)
    # and compute its fixed transform (R, p) within that link's frame ----
    # depth-first traversal in document order (matches Isaac's DFS body /
    # dof ordering: per-leg grouping, hips at 0, 3, 6, 9)
    order = []
    stack = [u.root_link]
    while stack:
        name = stack.pop(0)
        order.append(name)
        stack = [j.child for j in children.get(name, [])] + stack

    link_names = [u.root_link]
    link_parent = [-1]
    movable_joints = []          # (Joint, Rp, pp) per link i+1
    # owner[orig_link] = (link_idx, R, p): frame of orig link in owner frame
    owner = {u.root_link: (0, np.eye(3), np.zeros(3))}
    for name in order:
        if name == u.root_link:
            continue
        j = joints_by_child[name]
        if j.kind in MOVABLE:
            idx = len(link_names)
            link_names.append(j.child)
            parent_link, Rp, pp = owner[j.parent]
            link_parent.append(parent_link)
            movable_joints.append((j, Rp, pp))
            owner[j.child] = (idx, np.eye(3), np.zeros(3))
        elif j.kind == "fixed":
            li, Rp, pp = owner[j.parent]
            owner[j.child] = (li, Rp @ j.rot, pp + Rp @ j.pos)
        else:
            raise ValueError(f"unsupported joint type {j.kind} ({j.name})")

    nq = len(movable_joints)
    nl = nq + 1

    # --- joint arrays: tree transform parent link frame -> child link frame
    joint_pos = np.zeros((nq, 3))
    joint_rot = np.zeros((nq, 3, 3))
    joint_axis = np.zeros((nq, 3))
    joint_is_prismatic = np.zeros(nq, dtype=bool)
    dof_names, lower, upper, vel, eff, damp, fric = [], [], [], [], [], [], []
    for i, (j, Rp, pp) in enumerate(movable_joints):
        joint_pos[i] = pp + Rp @ j.pos
        joint_rot[i] = Rp @ j.rot
        joint_axis[i] = j.axis
        joint_is_prismatic[i] = (j.kind == "prismatic")
        dof_names.append(j.name)
        lower.append(j.lower)
        upper.append(j.upper)
        vel.append(j.velocity)
        eff.append(j.effort)
        damp.append(j.damping)
        fric.append(j.friction)

    # --- inertia contributions per original link ---
    orig_names, contrib, contrib_link, orig_is_base = [], [], [], []
    for name in order:
        link = u.links[name]
        if link.mass <= 0.0:
            continue
        li, R, p = owner[name]
        com = R @ link.com + p
        I_com = R @ link.inertia @ R.T
        orig_names.append(name)
        contrib.append(_inertia_params(link.mass, com, I_com))
        contrib_link.append(li)
        orig_is_base.append(li == 0)
    contrib = np.array(contrib) if contrib else np.zeros((0, 10))

    # --- report bodies ---
    # kept = base link, every movable-joint child, and fixed links whose
    # joint has dont_collapse (or everything if collapse_fixed_joints=False)
    body_names, body_link, body_pos, body_rot = [], [], [], []
    body_of = {}
    for name in order:
        j = joints_by_child.get(name)
        keep = (
            j is None
            or j.kind in MOVABLE
            or (j.kind == "fixed" and j.dont_collapse and keep_feet)
            or not collapse_fixed_joints
        )
        # the root's first fixed child often carries the inertia (go1:
        # base->trunk); it is merged into the base body, not kept.
        if keep:
            li, R, p = owner[name]
            body_of[name] = len(body_names)
            body_names.append(name)
            body_link.append(li)
            body_pos.append(p)
            body_rot.append(R)
    for name in order:
        if name not in body_of:
            # merged: report under the body of its owner link
            li, _, _ = owner[name]
            # find the kept body whose frame IS the link frame
            body_of[name] = body_link.index(li)

    # --- collision points ---
    cp_link, cp_body, cp_pos, cp_radius = [], [], [], []
    for name in order:
        link = u.links[name]
        li, R, p = owner[name]
        for geom in link.collisions:
            # geom offsets are in the original link frame; move to owner link
            g = dataclasses.replace(geom, pos=p + R @ geom.pos, rot=R @ geom.rot)
            for off, r in _geom_points(g):
                cp_link.append(li)
                cp_body.append(body_of[name])
                cp_pos.append(off)
                cp_radius.append(r)

    total_mass = float(contrib[:, 0].sum()) if len(contrib) else 0.0

    return RobotModel(
        name=u.name,
        nq=nq, nl=nl,
        dof_names=tuple(dof_names), link_names=tuple(link_names),
        link_parent=np.array(link_parent, dtype=np.int32),
        joint_pos=joint_pos, joint_rot=joint_rot, joint_axis=joint_axis,
        joint_is_prismatic=joint_is_prismatic,
        dof_lower=np.array(lower), dof_upper=np.array(upper),
        dof_vel_limit=np.array(vel), dof_effort=np.array(eff),
        dof_damping=np.array(damp), dof_friction=np.array(fric),
        armature=np.full(nq, armature),
        n_orig=len(orig_names), orig_names=tuple(orig_names),
        contrib=contrib, contrib_link=np.array(contrib_link, dtype=np.int32),
        orig_is_base=np.array(orig_is_base, dtype=bool),
        body_names=tuple(body_names),
        body_link=np.array(body_link, dtype=np.int32),
        body_pos=np.array(body_pos), body_rot=np.array(body_rot),
        cp_link=np.array(cp_link, dtype=np.int32),
        cp_body=np.array(cp_body, dtype=np.int32),
        cp_pos=np.array(cp_pos) if cp_pos else np.zeros((0, 3)),
        cp_radius=np.array(cp_radius),
        total_mass=total_mass,
    )
