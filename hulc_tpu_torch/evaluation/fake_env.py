"""In-process fake CALVIN environment for rollout tests (no PyBullet); the
port's copy of hulc_tpu/evaluation/fake_env.py, held against it by
tests/test_torch_eval_env.py.

Implements the env contract the evaluator drives (reconstructed from the
reference call sites — SURVEY.md §2.9 CalvinEnvWrapper):

    obs = env.reset(robot_obs=..., scene_obs=...)
    obs = env.step(action)          # 7-dof world-frame action
    info = env.get_info()           # consumed by the tasks oracle

obs = {"rgb_obs": {"rgb_static": (H,W,3) u8, "rgb_gripper": ...},
       "depth_obs": {}, "robot_obs": (15,) float}.

Two dynamics levels:

* default: deliberately trivial (kinematic TCP integration + scripted scene
  hooks) — tests drive the scene with :meth:`script_scene` to emulate task
  success/failure deterministically; the scene never moves on its own.
* ``interactive=True``: a kinematic playtable where the scene RESPONDS to
  the TCP — slider/drawer handles drag their joints, button/switch sites
  toggle the lights, blocks can be grasped (gripper-closing transition in
  range), carried, rotated, pushed, stacked, and dropped into regions.
  ``get_info()`` then also emits real ``block_contacts`` (gripper / table /
  plank / drawer / block_*), which upgrades the SceneObsTasks oracle from
  its position-box fallbacks to contact-driven checks — including the
  otherwise-untestable place_* family (reference: calvin_env's PyBullet
  contact lists, conf/callbacks/rollout/tasks/new_playtable_tasks.yaml).
  Geometry constants are shared with chain_sampler.initial_state_to_obs /
  the SceneObsTasks region boxes so feasibility-filtered protocol chains
  are physically realizable end-to-end (see evaluation/expert.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from hulc_tpu_torch.evaluation.tasks import DRAWER_BOX, SLIDER_BOX, _in_box

# ---------------------------------------------------------------------------
# Interactive playtable geometry (shared with evaluation/expert.py).
# Consistent with chain_sampler's reset vectors and tasks.py region boxes:
# table z 0.46; SLIDER_BOX z (0.50, 0.65); DRAWER_BOX z (0.30, 0.42).
# ---------------------------------------------------------------------------
TABLE_Z = 0.46
SLIDER_RANGE = (0.0, 0.28)  # joint: 0 = right, 0.28 = left
DRAWER_RANGE = (0.0, 0.22)  # joint: 0 = closed, 0.22 = open
BUTTON_SITE = np.array([-0.12, -0.10, 0.52], np.float32)  # toggles led (scene[5])
SWITCH_SITE = np.array([0.30, 0.10, 0.54], np.float32)  # toggles bulb (scene[4])
DRAWER_OPENING_XY = ((0.0, 0.35), (-0.1, 0.2))  # blocks pushed here fall in
DRAWER_INSIDE_Z = 0.36
GRASP_R = 0.04  # gripper-closing transition within this of a block grasps it
PUSH_R = 0.05  # TCP xy-near a block at its height drags it along
HANDLE_R = 0.045  # TCP within this of a handle drags the joint
TOGGLE_R = 0.03  # entering this radius of a site toggles its light
STACK_XY = 0.04  # release near another block snaps on top of it
STACK_DZ = 0.05

_BLOCK_SLICES = {"block_red": slice(6, 12), "block_blue": slice(12, 18), "block_pink": slice(18, 24)}

# ---------------------------------------------------------------------------
# Schematic renderer (interactive playtable).
#
# The legacy obs images were a flat color encoding only tanh(tcp) — fine for
# plumbing tests, but structurally insufficient for a LEARNED policy: the
# scene (blocks, slider, drawer, lights) was invisible, so no vision-only
# policy could ever score on the evaluator. This
# renderer rasterizes the full scene state orthographically so the standard
# HULC vision stack (SpatialSoftmax keypoints — reference
# hulc/models/perceptual_encoders/vision_network.py) can recover everything
# the scripted expert conditions on: block xy (colored squares) + height
# (marker size) + yaw (directional tick), slider door position, drawer
# extension, light states, and the TCP (crosshair; size encodes z, color
# encodes gripper open/closed). The gripper camera is a zoomed crop around
# the TCP (fine positioning signal) with a z-indicator bar on the left edge.
# Deterministic pure function of (robot_obs, scene_obs, held) — identical at
# data-collection and evaluation time.
# ---------------------------------------------------------------------------

STATIC_VIEW = (-0.45, 0.47, -0.42, 0.50)  # x0, x1, y0, y1 (world metres)
GRIPPER_HALF = 0.08  # gripper-cam half-extent around the TCP

_COL = {
    "table": (70, 62, 54),
    "drawer_hole": (24, 20, 18),
    "drawer_front": (110, 88, 60),
    "slot": (48, 44, 40),
    "door": (130, 100, 62),
    "led_on": (40, 230, 70), "led_off": (28, 56, 34),
    "bulb_on": (250, 215, 70), "bulb_off": (72, 66, 38),
    "block_red": (225, 45, 40), "block_blue": (50, 90, 235), "block_pink": (240, 130, 195),
    "tcp_open": (245, 245, 245), "tcp_closed": (70, 235, 235),
    "zbar": (180, 180, 60),
}


def _rect(img, view, cx, cy, w, h, color):
    x0, x1, y0, y1 = view
    px_v, px_u = img.shape[:2]
    sx = px_u / (x1 - x0)
    sy = px_v / (y1 - y0)
    u0 = max(int((cx - w / 2 - x0) * sx), 0)
    u1 = min(int(np.ceil((cx + w / 2 - x0) * sx)), px_u)
    v0 = max(int((cy - h / 2 - y0) * sy), 0)
    v1 = min(int(np.ceil((cy + h / 2 - y0) * sy)), px_v)
    if u1 > u0 and v1 > v0:
        img[v0:v1, u0:u1] = color


def render_scene(robot_obs, scene_obs, px: int, view=STATIC_VIEW, held=None) -> np.ndarray:
    robot = np.asarray(robot_obs, np.float32)
    scene = np.asarray(scene_obs, np.float32)
    img = np.empty((px, px, 3), np.uint8)
    img[:] = _COL["table"]

    # drawer: a hole whose darkness area tracks the joint + a front bar
    joint_d = float(scene[1])
    (hx0, hx1), (hy0, hy1) = DRAWER_OPENING_XY
    if joint_d > 0.01:
        _rect(img, view, (hx0 + hx1) / 2, (hy0 + hy1) / 2, hx1 - hx0,
              (hy1 - hy0) * min(joint_d / 0.22, 1.0), _COL["drawer_hole"])
    _rect(img, view, 0.18, -0.12 - joint_d, 0.28, 0.05, _COL["drawer_front"])

    # slider cabinet: two slots, then blocks resting on the plank, then the
    # door OVER the covered slot (a block behind the closed door is hidden —
    # matching its unreachability)
    for sx_, sy_ in ((-0.28, 0.10), (0.02, 0.10)):
        _rect(img, view, sx_, sy_, 0.11, 0.12, _COL["slot"])
    (bx0, bx1), (by0, by1), (bz0, _) = SLIDER_BOX

    def draw_block(name, sl):
        pos = scene[sl][:3]
        yaw = float(scene[sl][5])
        size = 0.036 + 0.06 * max(float(pos[2]) - TABLE_Z, 0.0)
        _rect(img, view, pos[0], pos[1], size, size, _COL[name])
        # yaw tick: three dots from the centre along the block's heading
        for r in (0.012, 0.020, 0.028):
            _rect(img, view, pos[0] + r * math.cos(yaw), pos[1] + r * math.sin(yaw),
                  0.008, 0.008, tuple(c // 2 for c in _COL[name]))

    def on_plank(sl):
        pos = scene[sl][:3]
        return bx0 <= pos[0] <= bx1 and by0 <= pos[1] <= by1 and pos[2] >= bz0

    order = sorted(_BLOCK_SLICES, key=lambda b: float(scene[_BLOCK_SLICES[b]][2]))
    for b in order:
        if on_plank(_BLOCK_SLICES[b]) and b != held:
            draw_block(b, _BLOCK_SLICES[b])
    joint_s = float(scene[0])
    _rect(img, view, 0.02 - joint_s, 0.10, 0.13, 0.13, _COL["door"])
    # door handle nub so the policy can find the grab point
    _rect(img, view, 0.06 - joint_s, 0.02, 0.018, 0.018, _COL["drawer_front"])

    # light indicators at their trigger sites
    _rect(img, view, BUTTON_SITE[0], BUTTON_SITE[1], 0.045, 0.045,
          _COL["led_on"] if round(float(scene[5])) else _COL["led_off"])
    _rect(img, view, SWITCH_SITE[0], SWITCH_SITE[1], 0.045, 0.045,
          _COL["bulb_on"] if round(float(scene[4])) else _COL["bulb_off"])

    # free-standing / carried blocks (lowest first so stacks read correctly)
    for b in order:
        if not on_plank(_BLOCK_SLICES[b]) or b == held:
            draw_block(b, _BLOCK_SLICES[b])

    # TCP crosshair: arm length encodes z, color encodes gripper state
    tcp = robot[:3]
    closed = robot[14] < 0
    col = _COL["tcp_closed"] if closed else _COL["tcp_open"]
    arm = 0.030 + 0.10 * max(float(tcp[2]) - 0.40, 0.0)
    _rect(img, view, tcp[0], tcp[1], arm, 0.010, col)
    _rect(img, view, tcp[0], tcp[1], 0.010, arm, col)
    return img


def render_gripper_cam(robot_obs, scene_obs, px: int, held=None) -> np.ndarray:
    robot = np.asarray(robot_obs, np.float32)
    tcp = robot[:3]
    view = (tcp[0] - GRIPPER_HALF, tcp[0] + GRIPPER_HALF,
            tcp[1] - GRIPPER_HALF, tcp[1] + GRIPPER_HALF)
    img = render_scene(robot_obs, scene_obs, px, view=view, held=held)
    # z-indicator: a bar up the left edge, filled proportionally to TCP height
    fill = int(np.clip((float(tcp[2]) - 0.30) / 0.50, 0.0, 1.0) * px)
    if fill > 0:
        img[px - fill :, : max(px // 16, 2)] = _COL["zbar"]
    return img


def slider_handle(joint: float) -> np.ndarray:
    """Handle position for slider joint value (moves -x as the door goes left)."""
    return np.array([0.06 - joint, 0.02, 0.53], np.float32)


def drawer_handle(joint: float) -> np.ndarray:
    """Handle position for drawer joint value (moves -y as the drawer opens)."""
    return np.array([0.18, -0.12 - joint, 0.40], np.float32)


class FakeCalvinEnv:
    def __init__(
        self,
        static_px: int = 64,
        gripper_px: int = 48,
        seed: int = 0,
        interactive: bool = False,
    ):
        self.static_px = static_px
        self.gripper_px = gripper_px
        self.interactive = interactive
        self.rng = np.random.default_rng(seed)
        self.robot_obs = np.zeros(15, np.float32)
        self.scene_obs = np.zeros(24, np.float32)
        self.t = 0
        self._scripted = None
        self._held: Optional[str] = None  # interactive: block in the gripper
        self._gripper_closed = False

    # ------------------------------------------------------------------
    # env contract
    # ------------------------------------------------------------------

    def reset(self, robot_obs: Optional[np.ndarray] = None, scene_obs: Optional[np.ndarray] = None):
        if robot_obs is not None:
            self.robot_obs = np.asarray(robot_obs, np.float32).copy()
        else:
            self.robot_obs = np.zeros(15, np.float32)
            self.robot_obs[2] = 0.55  # tcp z above the table
        if scene_obs is not None:
            self.scene_obs = np.asarray(scene_obs, np.float32).copy()
        else:
            self.scene_obs = np.zeros(24, np.float32)
            for sl in (slice(6, 12), slice(12, 18), slice(18, 24)):
                self.scene_obs[sl][:3] = self.rng.uniform(-0.2, 0.2, 3)
                self.scene_obs[sl][2] = 0.46
        self.t = 0
        self._held = None
        self._gripper_closed = self.robot_obs[14] < 0
        return self._obs()

    def step(self, action):
        action = np.asarray(action, np.float32).reshape(-1)
        prev_tcp = self.robot_obs[:3].copy()
        prev_yaw = float(self.robot_obs[5])
        # kinematic relative TCP integration (rel_actions scaling: pos/50, orn/20)
        self.robot_obs[:3] += np.clip(action[:3], -1, 1) / 50.0
        self.robot_obs[3:6] += np.clip(action[3:6], -1, 1) / 20.0
        self.robot_obs[14] = np.sign(action[6]) if action[6] != 0 else self.robot_obs[14]
        if self.interactive:
            self._scene_step(prev_tcp, prev_yaw, float(action[6]))
        if self._scripted is not None:
            self._scripted(self, self.t)
        self.t += 1
        return self._obs()

    def get_info(self) -> Dict:
        info = {"scene_obs": self.scene_obs.copy()}
        if self.interactive:
            info["block_contacts"] = self._block_contacts()
        return info

    def get_obs(self):
        return self._obs()

    # ------------------------------------------------------------------
    # interactive playtable dynamics
    # ------------------------------------------------------------------

    def _block_pos(self, block: str) -> np.ndarray:
        return self.scene_obs[_BLOCK_SLICES[block]][:3]

    def _scene_step(self, prev_tcp: np.ndarray, prev_yaw: float, grip_action: float) -> None:
        tcp = self.robot_obs[:3]
        d_tcp = tcp - prev_tcp
        d_yaw = float(self.robot_obs[5]) - prev_yaw

        # articulated joints: a TCP within handle range drags the joint by its
        # own displacement along the joint axis (handle tracks the joint, so an
        # engaged TCP moving at the same rate stays engaged)
        if np.linalg.norm(prev_tcp - slider_handle(float(self.scene_obs[0]))) < HANDLE_R:
            self.scene_obs[0] = np.clip(self.scene_obs[0] - d_tcp[0], *SLIDER_RANGE)
        if np.linalg.norm(prev_tcp - drawer_handle(float(self.scene_obs[1]))) < HANDLE_R:
            self.scene_obs[1] = np.clip(self.scene_obs[1] - d_tcp[1], *DRAWER_RANGE)

        # light sites: edge-triggered toggle on ENTERING the radius
        for site, joint_i, light_i in ((BUTTON_SITE, 2, 5), (SWITCH_SITE, 3, 4)):
            entered = (
                np.linalg.norm(tcp - site) < TOGGLE_R
                and np.linalg.norm(prev_tcp - site) >= TOGGLE_R
            )
            if entered:
                self.scene_obs[light_i] = 1.0 - round(float(self.scene_obs[light_i]))
                self.scene_obs[joint_i] = self.scene_obs[light_i]

        closing = grip_action < 0 and not self._gripper_closed
        opening = grip_action > 0 and self._gripper_closed

        if self._held is None and closing:
            # grasp the nearest block in range
            cands = [
                (float(np.linalg.norm(tcp - self._block_pos(b))), b)
                for b in _BLOCK_SLICES
            ]
            dist, best = min(cands)
            if dist < GRASP_R:
                self._held = best

        if self._held is not None:
            sl = _BLOCK_SLICES[self._held]
            self.scene_obs[sl][:3] = tcp
            self.scene_obs[sl][5] += d_yaw  # grasped block follows TCP yaw
            if opening:
                self._held = None
        else:
            # pushing: an un-grasped block near the TCP at its own height is
            # dragged along the TCP's horizontal displacement; a CLOSED
            # gripper in grasp range also spins it with the TCP yaw (friction
            # rotation — lets rotate_* tasks complete without a grasp, so the
            # block's "table" contact survives into the next subtask's start
            # snapshot)
            for b in _BLOCK_SLICES:
                pos = self._block_pos(b)
                in_spin_range = np.linalg.norm(prev_tcp - pos) < GRASP_R
                if (
                    np.linalg.norm(prev_tcp[:2] - pos[:2]) < PUSH_R
                    and abs(prev_tcp[2] - pos[2]) < 0.04
                ):
                    pos[:2] += d_tcp[:2]
                    if self._gripper_closed and in_spin_range:
                        self.scene_obs[_BLOCK_SLICES[b]][5] += d_yaw

        # gravity: every free block falls to its highest support below it
        # (pull-down only — a block already resting below a support level,
        # e.g. inside a now-closed drawer, never teleports upward)
        for b in _BLOCK_SLICES:
            if b != self._held:
                self._rest(b)

        if grip_action != 0:
            self._gripper_closed = grip_action < 0

    def _rest(self, block: str) -> None:
        """Drop ``block`` to the highest support under its xy position:
        another block's top, the slider plank, the open-drawer floor (a hole
        in the table), or the table surface."""
        pos = self._block_pos(block)
        support = TABLE_Z
        (x0, x1), (y0, y1) = DRAWER_OPENING_XY
        if x0 <= pos[0] <= x1 and y0 <= pos[1] <= y1 and self.scene_obs[1] > 0.12:
            support = DRAWER_INSIDE_Z  # the open drawer is a hole in the table
        (sx0, sx1), (sy0, sy1), (sz0, _) = SLIDER_BOX
        if sx0 <= pos[0] <= sx1 and sy0 <= pos[1] <= sy1 and pos[2] >= sz0:
            support = 0.55  # the slider plank surface
        for other in _BLOCK_SLICES:
            if other == block:
                continue
            opos = self._block_pos(other)
            top = opos[2] + STACK_DZ
            if (
                np.linalg.norm(pos[:2] - opos[:2]) < STACK_XY
                and top > support
                and top <= pos[2] + 1e-6
            ):
                support = top
        if support < pos[2] - 1e-6:
            pos[2] = support

    def _block_contacts(self) -> Dict[str, list]:
        return contacts_from_state(self.robot_obs, self.scene_obs, held=self._held)

    # ------------------------------------------------------------------

    def script_scene(self, fn) -> None:
        """fn(env, t): mutate env.scene_obs each step (test hook)."""
        self._scripted = fn

    def _obs(self):
        def img(px):
            base = (np.tanh(self.robot_obs[:3]).reshape(1, 1, 3) * 60 + 128).astype(np.uint8)
            return np.broadcast_to(base, (px, px, 3)).copy()

        if self.interactive:
            static = render_scene(self.robot_obs, self.scene_obs, self.static_px, held=self._held)
            gripper = render_gripper_cam(self.robot_obs, self.scene_obs, self.gripper_px, held=self._held)
        else:
            static, gripper = img(self.static_px), img(self.gripper_px)
        return {
            "rgb_obs": {
                "rgb_static": static,
                "rgb_gripper": gripper,
            },
            "depth_obs": {},
            "robot_obs": self.robot_obs.copy(),
            # calvin_env exposes scene_obs in the state obs (used only by
            # robot_scene proprioception configs; everyone else ignores it)
            "scene_obs": self.scene_obs.copy(),
        }


def contacts_from_state(
    robot_obs, scene_obs, held: Optional[str] = "infer"
) -> Dict[str, list]:
    """Kinematic block-contact reconstruction from (robot_obs, scene_obs).

    The geometry rules of the interactive playtable as a pure function, so
    recorded play data can be annotated with the same contact semantics the
    live env emits (language-annotation pipeline, data/language.py). With
    ``held="infer"``, a block is read as grasped when the gripper is closed
    and the block rides exactly on the TCP (held blocks track it, so the
    distance is ~0 in recorded frames).
    """
    robot = np.asarray(robot_obs, np.float32)
    scene = np.asarray(scene_obs, np.float32)

    def block_pos(b):
        return scene[_BLOCK_SLICES[b]][:3]

    if held == "infer":
        held = None
        if robot[14] < 0:
            dists = [(float(np.linalg.norm(robot[:3] - block_pos(b))), b) for b in _BLOCK_SLICES]
            d, b = min(dists)
            if d < 0.005:
                held = b

    out: Dict[str, list] = {}
    for b in _BLOCK_SLICES:
        pos = block_pos(b)
        stacked_on = [
            o
            for o in _BLOCK_SLICES
            if o != b
            and np.linalg.norm(pos[:2] - block_pos(o)[:2]) < STACK_XY
            and 0.02 < pos[2] - block_pos(o)[2] < 0.09
        ]
        if b == held:
            out[b] = ["gripper"]
        elif stacked_on:
            out[b] = stacked_on
        elif _in_box(pos, DRAWER_BOX):
            out[b] = ["drawer"]
        elif _in_box(pos, SLIDER_BOX):
            out[b] = ["plank"]
        elif abs(pos[2] - TABLE_Z) < 0.02:
            out[b] = ["table"]
        else:
            out[b] = []
    return out


def fake_env_for(cfg, interactive: bool = False) -> "FakeCalvinEnv":
    """FakeCalvinEnv emitting frames at the config's camera resolutions
    (the constructor defaults are debug-sized; full-size configs crashed
    the policy's encoder on mismatched flatten dims)."""
    pe = cfg.perceptual_encoder
    if pe.rgb_static is None:  # state_only: frames exist but the policy ignores them
        static = 64
    else:
        static = pe.rgb_static.input_size if pe.rgb_static.kind != "clip" else 200
    gripper = pe.rgb_gripper.input_size if pe.rgb_gripper is not None else 84
    return FakeCalvinEnv(static_px=static, gripper_px=gripper, interactive=interactive)
