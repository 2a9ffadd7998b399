"""Minimal URDF parser producing Featherstone-style rigid-body model arrays.

A numpy-only copy of gato_tpu/robots/urdf.py: importing anything from
`gato_tpu` imports jax (gato_tpu/__init__.py), which this package never does.

TPU-native re-design of the reference's GRiD-codegen dynamics layer
(reference: gato/dynamics/README.md, gato/dynamics/indy7/indy7_grid.cuh:47-68).
Instead of generating unrolled CUDA per robot, we parse the URDF at
construction time into dense numpy arrays that become a `RobotModel` pytree;
all dynamics algorithms are generic JAX code jit-specialized on the (static)
joint count, which plays the same role as GRiD's per-robot codegen.

Only the URDF subset used by serial manipulators is supported:
revolute/continuous joints with an arbitrary fixed axis, and fixed joints
(whose child-link inertias are fused into the parent, matching how GRiD and
Pinocchio reduce fixed joints).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np


def _floats(s: str | None, default: str = "0 0 0") -> np.ndarray:
    return np.array([float(x) for x in (s or default).split()], dtype=np.float64)


def rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw to rotation matrix: R = Rz(y) Ry(p) Rx(r)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def skew(v: np.ndarray) -> np.ndarray:
    return np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]]
    )


def spatial_inertia(mass: float, com: np.ndarray, I_com: np.ndarray) -> np.ndarray:
    """6x6 spatial inertia in link frame from mass, COM offset, rotational
    inertia about the COM. Convention: motion [w; v], force [n; f]."""
    C = skew(com)
    I6 = np.zeros((6, 6))
    I6[:3, :3] = I_com + mass * (C @ C.T)
    I6[:3, 3:] = mass * C
    I6[3:, :3] = mass * C.T
    I6[3:, 3:] = mass * np.eye(3)
    return I6


def transform_inertia(I6: np.ndarray, R: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Express a child-frame spatial inertia in the parent frame, given the
    homogeneous transform (R, p) of the child frame in the parent frame.

    Uses I_parent = X^T I_child X with X the motion transform child<-parent,
    X = [[E, 0], [-E*skew(p), E]], E = R^T.
    """
    E = R.T
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, :3] = -E @ skew(p)
    X[3:, 3:] = E
    return X.T @ I6 @ X


@dataclass
class _Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    I_com: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    inertia_origin_rpy: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class _Joint:
    name: str
    jtype: str
    parent: str
    child: str
    R: np.ndarray  # rotation of joint/child frame in parent frame (at q = 0)
    p: np.ndarray  # position of joint/child frame origin in parent frame
    axis: np.ndarray
    limit_lower: float = 0.0
    limit_upper: float = 0.0
    limit_velocity: float = 0.0
    limit_effort: float = 0.0


@dataclass
class ParsedRobot:
    """Plain-numpy robot description (pre-pytree)."""

    name: str
    nq: int
    joint_names: list[str]
    # Per movable joint i (0..nq-1):
    R_tree: np.ndarray  # (nq, 3, 3) child frame rotation in parent frame at q=0
    p_tree: np.ndarray  # (nq, 3)   child frame origin in parent frame
    axis: np.ndarray  # (nq, 3)   joint axis in child frame
    inertia: np.ndarray  # (nq, 6, 6) spatial inertia of the link carried by joint i
    # limits
    joint_limits: np.ndarray  # (nq, 2) lower/upper position
    velocity_limits: np.ndarray  # (nq, 2)
    effort_limits: np.ndarray  # (nq, 2)
    # fixed end-effector offset appended after the last joint (homogeneous)
    R_ee: np.ndarray  # (3, 3)
    p_ee: np.ndarray  # (3,)


def _parse_links(root: ET.Element) -> dict[str, _Link]:
    links: dict[str, _Link] = {}
    for le in root.findall("link"):
        link = _Link(name=le.get("name"))
        ine = le.find("inertial")
        if ine is not None:
            origin = ine.find("origin")
            if origin is not None:
                link.com = _floats(origin.get("xyz"))
                link.inertia_origin_rpy = _floats(origin.get("rpy"))
            m = ine.find("mass")
            link.mass = float(m.get("value")) if m is not None else 0.0
            it = ine.find("inertia")
            if it is not None:
                g = lambda k: float(it.get(k, "0"))
                I = np.array(
                    [
                        [g("ixx"), g("ixy"), g("ixz")],
                        [g("ixy"), g("iyy"), g("iyz")],
                        [g("ixz"), g("iyz"), g("izz")],
                    ]
                )
                Rr = rpy_to_matrix(link.inertia_origin_rpy)
                link.I_com = Rr @ I @ Rr.T
        links[link.name] = link
    return links


def _parse_joints(root: ET.Element) -> list[_Joint]:
    joints = []
    for je in root.findall("joint"):
        origin = je.find("origin")
        rpy = _floats(origin.get("rpy")) if origin is not None else np.zeros(3)
        xyz = _floats(origin.get("xyz")) if origin is not None else np.zeros(3)
        axis_el = je.find("axis")
        axis = _floats(axis_el.get("xyz"), "0 0 1") if axis_el is not None else np.array([0.0, 0.0, 1.0])
        lim = je.find("limit")
        j = _Joint(
            name=je.get("name"),
            jtype=je.get("type"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
            R=rpy_to_matrix(rpy),
            p=xyz,
            axis=axis / max(np.linalg.norm(axis), 1e-12),
        )
        if lim is not None:
            j.limit_lower = float(lim.get("lower", "0"))
            j.limit_upper = float(lim.get("upper", "0"))
            j.limit_velocity = float(lim.get("velocity", "0"))
            j.limit_effort = float(lim.get("effort", "0"))
        joints.append(j)
    return joints


def parse_urdf(path: str) -> ParsedRobot:
    """Parse a serial-chain URDF into dense arrays.

    Fixed joints are reduced: a fixed child link's inertia is transformed into
    its (movable) parent link's frame and accumulated there. The chain of
    fixed joints hanging off the last movable link defines the end-effector
    offset transform (R_ee, p_ee); note the reference's generated kinematics
    ignores this offset when reporting EE position
    (indy7_grid.cuh:1888 "TODO: ADD OFFSETS"), and we mirror that in
    `ee_position` while still exposing the offset for users.
    """
    root = ET.parse(path).getroot()
    links = _parse_links(root)
    joints = _parse_joints(root)

    by_child: dict[str, _Joint] = {j.child: j for j in joints}
    children: dict[str, list[_Joint]] = {}
    for j in joints:
        children.setdefault(j.parent, []).append(j)

    # find root link (never a child)
    all_children = set(by_child)
    root_links = [name for name in links if name not in all_children]
    if len(root_links) != 1:
        raise ValueError(f"expected a single root link, got {root_links}")

    # walk the chain from the root, collecting movable joints in order;
    # fixed joints are fused (their subtree inertia accumulated into the
    # nearest movable ancestor link, with the correct frame shift).
    movable: list[_Joint] = []
    link_inertia: list[np.ndarray] = []  # per movable joint: lumped inertia

    def lump_subtree(link_name: str, R_acc: np.ndarray, p_acc: np.ndarray) -> np.ndarray:
        """Inertia of `link_name` and all fixed descendants, expressed in the
        frame located at (R_acc, p_acc) relative to that frame."""
        link = links[link_name]
        I6 = spatial_inertia(link.mass, link.com, link.I_com)
        total = transform_inertia(I6, R_acc, p_acc)
        for j in children.get(link_name, []):
            if j.jtype == "fixed":
                R_next = R_acc @ j.R
                p_next = p_acc + R_acc @ j.p
                total = total + lump_subtree(j.child, R_next, p_next)
        return total

    def next_movable(link_name: str, R_acc: np.ndarray, p_acc: np.ndarray):
        """Find the movable joint reachable from link_name through fixed
        joints; returns (joint, R, p) with the accumulated fixed offset."""
        out = []
        for j in children.get(link_name, []):
            if j.jtype == "fixed":
                out.extend(
                    next_movable(j.child, R_acc @ j.R, p_acc + R_acc @ j.p)
                )
            elif j.jtype in ("revolute", "continuous"):
                out.append((j, R_acc @ j.R, p_acc + R_acc @ j.p))
            else:
                raise ValueError(f"unsupported joint type {j.jtype}")
        return out

    cur = root_links[0]
    R_ee = np.eye(3)
    p_ee = np.zeros(3)
    while True:
        nxt = next_movable(cur, np.eye(3), np.zeros(3))
        if not nxt:
            # end of chain: accumulate the trailing fixed transform as EE offset
            def trailing(link_name, R_acc, p_acc):
                for j in children.get(link_name, []):
                    if j.jtype == "fixed":
                        return trailing(j.child, R_acc @ j.R, p_acc + R_acc @ j.p)
                return R_acc, p_acc

            R_ee, p_ee = trailing(cur, np.eye(3), np.zeros(3))
            break
        if len(nxt) > 1:
            raise ValueError("branching chains are not supported")
        j, R, p = nxt[0]
        j = _Joint(
            name=j.name, jtype=j.jtype, parent=j.parent, child=j.child,
            R=R, p=p, axis=j.axis,
            limit_lower=j.limit_lower, limit_upper=j.limit_upper,
            limit_velocity=j.limit_velocity, limit_effort=j.limit_effort,
        )
        movable.append(j)
        link_inertia.append(lump_subtree(j.child, np.eye(3), np.zeros(3)))
        cur = j.child

    nq = len(movable)
    return ParsedRobot(
        name=root.get("name", "robot"),
        nq=nq,
        joint_names=[j.name for j in movable],
        R_tree=np.stack([j.R for j in movable]),
        p_tree=np.stack([j.p for j in movable]),
        axis=np.stack([j.axis for j in movable]),
        inertia=np.stack(link_inertia),
        joint_limits=np.array([[j.limit_lower, j.limit_upper] for j in movable]),
        velocity_limits=np.array(
            [[-j.limit_velocity, j.limit_velocity] for j in movable]
        ),
        effort_limits=np.array([[-j.limit_effort, j.limit_effort] for j in movable]),
        R_ee=R_ee,
        p_ee=p_ee,
    )
