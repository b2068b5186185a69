"""Real-MuJoCo ground-truth worlds (the port's counterpart of
``mppi_gpu_tpu.envs.mujoco_world``; optional backend, ``--world mujoco``).

The reference's plant IS MuJoCo (reference src/PointMassEnv.cpp:53-61:
mj_loadXML + mj_makeData, stepped at timestep 0.01 with ~2 steps per 1/60 s
control cycle). The worlds here run the real engine on the host with the
reference-env API (``reset()``, ``simulate(u) -> done``, ``step(u)``,
``get_x()``, ``time``, ``set_state(x, time)``) and the reference's episode
semantics, for the point mass (from its params, or from a reference-schema
XML) and for the pendulum, cart-pole, planar and 3-D quadrotor and
two-link arm, each from an MJCF generated from its params, so the physics
constants are those of the torch worlds by construction. The MJCF strings
are the JAX package's, character for character. Needs the `mujoco`
package, imported only when a world is built; :func:`mujoco_available`
reports.
"""

from __future__ import annotations

import numpy as np

from mppi_gpu_tpu_torch.envs.params import WorldParams


def mujoco_available() -> bool:
    try:
        import mujoco  # noqa: F401

        return True
    except Exception:
        return False


def _point_mass_mjcf(p: WorldParams) -> str:
    """Minimal MJCF with `p.n_axes` slide joints matching the reference's
    point-mass envs (reference envs/point_mass{1,2,3}d.xml: armature 0.01,
    damping 0.1, limited ±1.4, gear 10, ctrlrange ±1, RK4 @ 0.01)."""
    axes = ["1 0 0", "0 1 0", "0 0 1"]
    joints = "\n".join(
        f'            <joint axis="{axes[i]}" name="agent_{i}" '
        f'range="-{p.joint_range} {p.joint_range}" type="slide"/>'
        for i in range(p.n_axes)
    )
    motors = "\n".join(
        f'        <motor gear="{p.gear}" joint="agent_{i}"/>'
        for i in range(p.n_axes)
    )
    return f"""
<mujoco model="tpu-mppi point mass {p.n_axes}d (generated)">
    <compiler inertiafromgeom="true" angle="radian"/>
    <default>
        <joint armature="{p.armature}" damping="{p.damping}" limited="true"/>
        <motor ctrllimited="true" ctrlrange="-{p.ctrl_range} {p.ctrl_range}"/>
    </default>
    <option gravity="0 0 0" integrator="RK4" timestep="{p.timestep}"/>
    <worldbody>
        <body name="agent" pos="0 0 .05">
{joints}
            <geom contype="1" conaffinity="1" name="agent" size=".05" type="sphere" rgba="0.12 0.22 0.55 1"/>
        </body>
    </worldbody>
    <actuator>
{motors}
    </actuator>
</mujoco>
"""


def _pendulum_mjcf(p) -> str:
    """Point-mass pendulum on a hinge, matching PendulumWorld's ODE
    (envs/pendulum_world.py): θ measured from upright (+z), I = m·l² via an
    explicit near-zero body inertia at the tip, joint damping b = c·m·l² so
    MuJoCo's −b·θ̇ torque reproduces the analytic −c·θ̇ angular-acceleration
    term, direct torque actuator clamped at ±max_torque."""
    b = p.damping * p.mass * p.length**2
    return f"""
<mujoco model="tpu-mppi pendulum (generated)">
    <compiler angle="radian"/>
    <option gravity="0 0 -{p.gravity}" integrator="RK4" timestep="{p.timestep}"/>
    <worldbody>
        <body name="pole" pos="0 0 0">
            <joint name="hinge" type="hinge" axis="0 1 0" damping="{b}"/>
            <geom type="capsule" fromto="0 0 0 0 0 {p.length}" size="0.02"
                  mass="0" contype="0" conaffinity="0" rgba="0.12 0.22 0.55 1"/>
            <inertial pos="0 0 {p.length}" mass="{p.mass}"
                      diaginertia="1e-9 1e-9 1e-9"/>
        </body>
    </worldbody>
    <actuator>
        <motor joint="hinge" gear="1" ctrllimited="true"
               ctrlrange="-{p.max_torque} {p.max_torque}"/>
    </actuator>
</mujoco>
"""


def _cartpole_mjcf(p) -> str:
    """Cart + pole matching CartPoleWorld's Barto ODE
    (envs/cartpole_world.py): slide-joint cart of mass m_c, hinge pole
    modelled as a uniform rod of half-length l (com at l, inertia about com
    m_p·l²/3 — exactly the 4/3 factor in the analytic denominator), no
    friction/damping, force actuator clamped at ±max_force. The analytic
    world's hard ±track_limit clamp maps to a (soft-constraint) joint
    range."""
    i_rod = p.pole_mass * p.pole_length**2 / 3.0
    return f"""
<mujoco model="tpu-mppi cart-pole (generated)">
    <compiler angle="radian"/>
    <option gravity="0 0 -{p.gravity}" integrator="RK4" timestep="{p.timestep}"/>
    <worldbody>
        <body name="cart" pos="0 0 0">
            <joint name="slide" type="slide" axis="1 0 0" limited="true"
                   range="-{p.track_limit} {p.track_limit}"/>
            <geom type="box" size="0.1 0.05 0.05" mass="{p.cart_mass}"
                  contype="0" conaffinity="0" rgba="0.25 0.25 0.28 1"/>
            <body name="pole" pos="0 0 0">
                <joint name="hinge" type="hinge" axis="0 1 0"/>
                <geom type="capsule" fromto="0 0 0 0 0 {2 * p.pole_length}"
                      size="0.02" mass="0" contype="0" conaffinity="0"
                      rgba="0.12 0.22 0.55 1"/>
                <inertial pos="0 0 {p.pole_length}" mass="{p.pole_mass}"
                          diaginertia="{i_rod} {i_rod} 1e-9"/>
            </body>
        </body>
    </worldbody>
    <actuator>
        <motor joint="slide" gear="1" ctrllimited="true"
               ctrlrange="-{p.max_force} {p.max_force}"/>
    </actuator>
</mujoco>
"""


def _quadrotor_mjcf(p) -> str:
    """Planar quadrotor matching QuadrotorWorld's ODE
    (envs/quadrotor_world.py): a free body constrained to the x–z plane by
    two slide joints + one hinge about y (all through the COM, so rotation
    and translation decouple exactly like the analytic model), point-mass
    inertial (m, I_yy = I), and two site-transmission thrusters at ∓arm x̂
    pushing along body +z — MuJoCo's site Jacobian reproduces both the
    tilted-thrust force F·(sin θ, 0, cos θ) and the differential torque
    r·(f_left − f_right) about y. ctrlrange [0, max_thrust] is the
    analytic world's thrust clamp."""
    return f"""
<mujoco model="tpu-mppi planar quadrotor (generated)">
    <compiler angle="radian"/>
    <option gravity="0 0 -{p.gravity}" integrator="RK4" timestep="{p.timestep}"/>
    <worldbody>
        <body name="quad" pos="0 0 0">
            <joint name="slide_x" type="slide" axis="1 0 0"/>
            <joint name="slide_z" type="slide" axis="0 0 1"/>
            <joint name="tilt" type="hinge" axis="0 1 0"/>
            <geom type="box" size="{p.arm} 0.02 0.008" mass="0"
                  contype="0" conaffinity="0" rgba="0.12 0.22 0.55 1"/>
            <inertial pos="0 0 0" mass="{p.mass}"
                      diaginertia="{p.inertia} {p.inertia} {p.inertia}"/>
            <site name="rotor_left" pos="-{p.arm} 0 0" size="0.015"
                  rgba="0.9 0.4 0.1 1"/>
            <site name="rotor_right" pos="{p.arm} 0 0" size="0.015"
                  rgba="0.1 0.6 0.3 1"/>
        </body>
    </worldbody>
    <actuator>
        <motor site="rotor_left" gear="0 0 1 0 0 0" ctrllimited="true"
               ctrlrange="0 {p.max_thrust}"/>
        <motor site="rotor_right" gear="0 0 1 0 0 0" ctrllimited="true"
               ctrlrange="0 {p.max_thrust}"/>
    </actuator>
</mujoco>
"""


def _arm_mjcf(p) -> str:
    """Two-link planar arm matching ArmWorld's manipulator ODE
    (envs/arm_world.py / models/arm.py): the analytic x-y plane maps to
    MuJoCo's x-z plane (gravity −z), hinge axes "0 -1 0" so positive q
    rotates +x toward +z exactly like the analytic angles. Each link is a
    uniform rod: explicit inertial with com at l/2 and I = m·l²/12 about
    the axes perpendicular to the rod (the same constants A/B/D/G1/G2 are
    built from). Joint damping b maps directly to MuJoCo's −b·q̇ torque;
    direct torque actuators clamped at the per-joint limits. (MuJoCo has
    no analog of the model's joint-rate saturation — at max_rate=12 rad/s
    it is a motor envelope the closed loop essentially never hits.)"""
    i1 = p.m1 * p.l1**2 / 12.0
    i2 = p.m2 * p.l2**2 / 12.0
    return f"""
<mujoco model="tpu-mppi two-link arm (generated)">
    <compiler angle="radian"/>
    <option gravity="0 0 -{p.gravity}" integrator="RK4" timestep="{p.timestep}"/>
    <worldbody>
        <body name="link1" pos="0 0 0">
            <joint name="shoulder" type="hinge" axis="0 -1 0" damping="{p.damping}"/>
            <geom type="capsule" fromto="0 0 0 {p.l1} 0 0" size="0.02"
                  mass="0" contype="0" conaffinity="0" rgba="0.12 0.22 0.55 1"/>
            <inertial pos="{0.5 * p.l1} 0 0" mass="{p.m1}"
                      diaginertia="1e-9 {i1} {i1}"/>
            <body name="link2" pos="{p.l1} 0 0">
                <joint name="elbow" type="hinge" axis="0 -1 0" damping="{p.damping}"/>
                <geom type="capsule" fromto="0 0 0 {p.l2} 0 0" size="0.018"
                      mass="0" contype="0" conaffinity="0" rgba="0.25 0.45 0.7 1"/>
                <inertial pos="{0.5 * p.l2} 0 0" mass="{p.m2}"
                          diaginertia="1e-9 {i2} {i2}"/>
            </body>
        </body>
    </worldbody>
    <actuator>
        <motor joint="shoulder" gear="1" ctrllimited="true"
               ctrlrange="-{p.max_t1} {p.max_t1}"/>
        <motor joint="elbow" gear="1" ctrllimited="true"
               ctrlrange="-{p.max_t2} {p.max_t2}"/>
    </actuator>
</mujoco>
"""


def _quadrotor3d_mjcf(p) -> str:
    """Full 3-D quadrotor matching Quadrotor3DWorld's rigid-body ODE
    (envs/quadrotor3d_world.py): one free joint (so qpos = [p, quat] and
    qvel = [v_world, ω_body] — exactly the analytic 13-state layout),
    point-mass inertial (m, diag J), and four site-transmission rotors in
    "+" configuration at ±arm on x̂/ŷ, each pushing along body +z with a
    yaw drag torque ±κ per unit thrust via the gear's torque-z component
    (CCW rotors 1/3 get +κ, CW rotors 2/4 get −κ). ctrlrange [0, f_max]
    is the analytic world's per-rotor clamp."""
    r, k = p.arm, p.kappa
    jx, jy, jz = p.inertia
    sites = "\n".join(
        f'            <site name="rotor{i}" pos="{x} {y} 0" size="0.015"/>'
        for i, (x, y) in enumerate([(r, 0), (0, r), (-r, 0), (0, -r)], start=1)
    )
    motors = "\n".join(
        f'        <motor site="rotor{i}" gear="0 0 1 0 0 {s * k}" '
        f'ctrllimited="true" ctrlrange="0 {p.max_thrust}"/>'
        for i, s in [(1, 1), (2, -1), (3, 1), (4, -1)]
    )
    return f"""
<mujoco model="tpu-mppi 3d quadrotor (generated)">
    <compiler angle="radian"/>
    <option gravity="0 0 -{p.gravity}" integrator="RK4" timestep="{p.timestep}"/>
    <worldbody>
        <body name="quad" pos="0 0 0">
            <freejoint/>
            <geom type="box" size="{r} {r} 0.008" mass="0"
                  contype="0" conaffinity="0" rgba="0.12 0.22 0.55 1"/>
            <inertial pos="0 0 0" mass="{p.mass}"
                      diaginertia="{jx} {jy} {jz}"/>
{sites}
        </body>
    </worldbody>
    <actuator>
{motors}
    </actuator>
</mujoco>
"""


class _MujocoWorldBase:
    """The reference-env API over `mj_step`, with the reference's episode
    semantics: done once sim time passes `sim_end`, checked BEFORE stepping
    (PointMassEnv.cpp:115-139). The state vector is [qpos, qvel]
    (PointMassEnv.cpp:190-198), which matches every family's torch state
    layout by joint declaration order. A subclass gives its MJCF generator
    (`_mjcf`), its start (`_start`: qpos and qvel after `mj_resetData`) and,
    where the actuators are rotors, its mixer (`_mix`)."""

    _mjcf = None

    def __init__(self, params) -> None:
        import mujoco

        self._mujoco = mujoco
        self.params = params
        self.m = self._model()
        self.d = mujoco.MjData(self.m)
        self.reset()

    def _model(self):
        return self._mujoco.MjModel.from_xml_string(type(self)._mjcf(self.params))

    def _mix(self, u) -> np.ndarray:
        return np.asarray(u, np.float64).reshape(-1)

    def reset(self) -> None:
        """At the torch world's start, at rest, the sim clock at one
        physics step."""
        self._mujoco.mj_resetData(self.m, self.d)
        self._start()
        self.d.time = self.params.timestep
        self._mujoco.mj_forward(self.m, self.d)

    def simulate(self, u) -> bool:
        """One control cycle: hold `u`, advance `control_period` of sim time
        (PointMassEnv.cpp:115-139)."""
        if self.d.time >= self.params.sim_end:
            return True
        self.d.ctrl[:] = self._mix(u)
        start = self.d.time
        while self.d.time - start < self.params.control_period - 1e-9:
            self._mujoco.mj_step(self.m, self.d)
        return False

    def step(self, u) -> None:
        """Single physics step (the reference's `step(x, u)`,
        PointMassEnv.cpp:175-188), for the mismatch harness."""
        self.d.ctrl[:] = self._mix(u)
        self._mujoco.mj_step(self.m, self.d)

    def get_x(self) -> np.ndarray:
        return np.concatenate([self.d.qpos, self.d.qvel]).astype(np.float32)

    @property
    def time(self) -> float:
        return float(self.d.time)

    def set_state(self, x, time: float) -> None:
        """Restore from a checkpoint: x = [qpos, qvel], sim time."""
        n = self.m.nq
        x = np.asarray(x, np.float64)
        self.d.qpos[:] = x[:n]
        self.d.qvel[:] = x[n:]
        self.d.time = float(time)
        self._mujoco.mj_forward(self.m, self.d)


class MujocoPointMassWorld(_MujocoWorldBase):
    """The very plant the reference simulates (reference
    src/PointMassEnv.cpp), from `params` or from a reference-schema XML at
    `xml_path`. Reset does one warm-up step (PointMassEnv.cpp:94)."""

    _mjcf = staticmethod(_point_mass_mjcf)

    def __init__(self, params: WorldParams, xml_path: str | None = None) -> None:
        self._xml_path = xml_path
        super().__init__(params)

    def _model(self):
        if self._xml_path is None:
            m = super()._model()
        else:
            m = self._mujoco.MjModel.from_xml_path(str(self._xml_path))
        if m.nu != self.params.n_axes or m.nq != self.params.n_axes:
            raise ValueError(
                f"MuJoCo model has nq={m.nq}, nu={m.nu}; expected "
                f"{self.params.n_axes} slide joints with one motor each"
            )
        return m

    def reset(self) -> None:
        self._mujoco.mj_resetData(self.m, self.d)
        self._mujoco.mj_step(self.m, self.d)  # warm-up (PointMassEnv.cpp:94)


class MujocoPendulumWorld(_MujocoWorldBase):
    """The pendulum, hanging at init_theta."""

    _mjcf = staticmethod(_pendulum_mjcf)

    def _start(self) -> None:
        self.d.qpos[0] = self.params.init_theta


class MujocoArmWorld(_MujocoWorldBase):
    """The two-link arm at init_state (MuJoCo's CRB dynamics, an
    independent derivation of the closed-form mass-matrix inverse the torch
    worlds use)."""

    _mjcf = staticmethod(_arm_mjcf)

    def _start(self) -> None:
        self.d.qpos[:] = self.params.init_state[:2]
        self.d.qvel[:] = self.params.init_state[2:]


class MujocoCartPoleWorld(_MujocoWorldBase):
    """The cart-pole, the pole tilted at init_theta."""

    _mjcf = staticmethod(_cartpole_mjcf)

    def _start(self) -> None:
        self.d.qpos[1] = self.params.init_theta


class MujocoQuadrotor3DWorld(_MujocoWorldBase):
    """The 3-D quadrotor at init_pos, level. The actuators are the four
    rotors, so the [F, τx, τy, τz] command is inverted to per-rotor thrusts
    here (ctrlrange [0, f_max] applies the envelope clamp, as the torch
    worlds do)."""

    _mjcf = staticmethod(_quadrotor3d_mjcf)

    def _mix(self, u) -> np.ndarray:
        # numpy twin of quadrotor3d_world.mix_to_rotors, once per physics step
        F, tx, ty, tz = np.asarray(u, np.float64).reshape(4)
        qf = F / 4.0
        gx, gy = tx / (2.0 * self.params.arm), ty / (2.0 * self.params.arm)
        gz = tz / (4.0 * self.params.kappa)
        return np.array([qf - gy + gz, qf + gx - gz, qf + gy + gz, qf - gx - gz])

    def _start(self) -> None:
        self.d.qpos[0:3] = self.params.init_pos
        self.d.qpos[3] = 1.0  # identity quaternion (w, x, y, z)


class MujocoQuadrotorWorld(_MujocoWorldBase):
    """The planar quadrotor at (init_x, init_z), level. The actuators are
    the two rotors, so the (F, D) command is mixed to per-rotor thrusts here
    (the MJCF's ctrlrange [0, f_max] applies the envelope clamp)."""

    _mjcf = staticmethod(_quadrotor_mjcf)

    def _mix(self, u) -> np.ndarray:
        u = np.asarray(u).reshape(-1)
        F, D = float(u[0]), float(u[1])
        return np.array([0.5 * (F + D), 0.5 * (F - D)])

    def _start(self) -> None:
        self.d.qpos[0] = self.params.init_x
        self.d.qpos[1] = self.params.init_z
