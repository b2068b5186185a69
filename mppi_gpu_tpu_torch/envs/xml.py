"""MuJoCo-XML ingestion for the point-mass world family (the port's copy of
``mppi_gpu_tpu.envs.xml``, which imports jax through its package).

The reference configures its ground-truth env with MuJoCo XML files
(reference envs/point_mass{1d,2d,3d}.xml, loaded via `mj_loadXML` in
PointMassEnv.cpp:57), and the YAML `env` key is a path to one. Here the same
XML files parameterize the analytic world directly: this module extracts the
physically meaningful numbers from the reference XML schema —

  * slide joints of the agent body  → number of axes, joint range,
    armature, damping (from <default><joint> or per-joint attributes)
  * agent sphere geom + compiler `inertiafromgeom` → body mass from the
    sphere volume at MuJoCo's default density 1000
  * <motor> actuators → gear, ctrlrange
  * <option> → physics timestep (integrator must be RK4 — the analytic world
    integrates with RK4; anything else is rejected loudly)
  * the `target` site position → a suggested goal, exposed to callers

— and builds :class:`~mppi_gpu_tpu_torch.envs.params.WorldParams` from them, so a
user can point `env:` at their existing reference XML and get the identical
world. Only the frictionless decoupled slide-joint schema is supported; XMLs
outside it (hinges, contacts, gravity along a joint axis) are rejected.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass

from mppi_gpu_tpu_torch.envs.params import DENSITY, WorldParams


class XMLWorldError(ValueError):
    """XML doesn't match the supported point-mass schema."""


@dataclass(frozen=True)
class XMLWorld:
    params: WorldParams
    target: tuple[float, ...]  # (n_axes,) target-site position (goal hint)
    model_name: str


def _f(attrs: dict, key: str, default: float) -> float:
    return float(attrs[key]) if key in attrs else default


def load_world_xml(path: str | os.PathLike) -> XMLWorld:
    root = ET.parse(path).getroot()
    if root.tag != "mujoco":
        raise XMLWorldError(f"{path}: not a MuJoCo XML (root <{root.tag}>)")

    # defaults
    ddef = root.find("default")
    joint_def = dict(ddef.find("joint").attrib) if ddef is not None and ddef.find("joint") is not None else {}
    motor_def = dict(ddef.find("motor").attrib) if ddef is not None and ddef.find("motor") is not None else {}

    opt = root.find("option")
    oattrs = dict(opt.attrib) if opt is not None else {}
    integrator = oattrs.get("integrator", "Euler")
    if integrator != "RK4":
        raise XMLWorldError(
            f"{path}: integrator '{integrator}' unsupported (analytic world is RK4)"
        )
    gravity = [float(v) for v in oattrs.get("gravity", "0 0 -9.81").split()]
    timestep = float(oattrs.get("timestep", "0.002"))

    # the agent body: must contain only slide joints + one sphere geom
    bodies = root.findall(".//worldbody//body")
    if not bodies:
        raise XMLWorldError(f"{path}: no <body> under <worldbody>")
    agent = bodies[0]
    joints = agent.findall("joint")
    if not joints:
        raise XMLWorldError(f"{path}: agent body has no joints")

    axes = []
    armature = damping = joint_range = None
    for j in joints:
        a = {**joint_def, **j.attrib}
        if a.get("type") != "slide":
            raise XMLWorldError(f"{path}: joint '{a.get('name')}' is not a slide joint")
        axis = [float(v) for v in a.get("axis", "0 0 1").split()]
        axes.append(axis)
        rng = [float(v) for v in a.get("range", "0 0").split()]
        jr = max(abs(rng[0]), abs(rng[1]))
        arm, dmp = _f(a, "armature", 0.0), _f(a, "damping", 0.0)
        for name, new, old in (("armature", arm, armature), ("damping", dmp, damping),
                               ("range", jr, joint_range)):
            if old is not None and not math.isclose(new, old):
                raise XMLWorldError(f"{path}: per-joint {name} values differ; need uniform axes")
        armature, damping, joint_range = arm, dmp, jr
        # gravity must have no component along any actuated axis (decoupled linear ODE)
        g_along = sum(g * ax for g, ax in zip(gravity, axis))
        if abs(g_along) > 1e-9:
            raise XMLWorldError(f"{path}: gravity along joint axis unsupported")

    sphere = next(
        (g for g in agent.findall("geom") if g.attrib.get("type") == "sphere"), None
    )
    if sphere is None:
        raise XMLWorldError(f"{path}: agent body needs a sphere geom for its mass")
    if "mass" in sphere.attrib:
        mass = float(sphere.attrib["mass"])
    else:
        r = float(sphere.attrib["size"].split()[0])
        density = _f(sphere.attrib, "density", DENSITY)
        mass = (4.0 / 3.0) * math.pi * r**3 * density

    # actuators: one motor per joint, uniform gear/ctrlrange
    motors = root.findall(".//actuator/motor")
    if len(motors) != len(joints):
        raise XMLWorldError(
            f"{path}: {len(motors)} motors for {len(joints)} joints (need 1:1)"
        )
    gear = ctrl_range = None
    for m in motors:
        a = {**motor_def, **m.attrib}
        g = _f(a, "gear", 1.0)
        cr = [float(v) for v in a.get("ctrlrange", "-1 1").split()]
        cr = max(abs(cr[0]), abs(cr[1]))
        if gear is not None and not (math.isclose(g, gear) and math.isclose(cr, ctrl_range)):
            raise XMLWorldError(f"{path}: motors must share gear/ctrlrange")
        gear, ctrl_range = g, cr

    params = WorldParams(
        n_axes=len(joints),
        mass=mass,
        armature=armature if armature is not None else 0.0,
        damping=damping if damping is not None else 0.0,
        # explicit None checks: gear="0" / ctrlrange="0 0" are legitimate XML
        # values that must be honored, not silently replaced by defaults
        gear=gear if gear is not None else 1.0,
        ctrl_range=ctrl_range if ctrl_range is not None else 1.0,
        joint_range=joint_range if joint_range is not None else math.inf,
        timestep=timestep,
    )

    target_site = next(
        (s for s in root.findall(".//worldbody/site") if s.attrib.get("name") == "target"),
        None,
    )
    target = ()
    if target_site is not None:
        pos = [float(v) for v in target_site.attrib.get("pos", "0 0 0").split()]
        target = tuple(pos[: len(joints)])

    return XMLWorld(
        params=params, target=target, model_name=root.attrib.get("model", "?")
    )
