"""Scripted expert policy for the interactive FakeCalvinEnv playtable; the
port's copy of hulc_tpu/evaluation/expert.py, held against it by
tests/test_torch_eval_env.py.

Drives every one of the 34 CALVIN tasks (tasks.py ALL_TASKS) to oracle
success through the kinematic scene dynamics of
``FakeCalvinEnv(interactive=True)``. Exposes the same surface
``evaluate_policy_batched`` drives on :class:`BatchedHulcPolicy`
(``num_envs`` / ``replan_freq`` / ``initial_state`` / ``step``), so the full
LH-MTLC protocol — feasibility-filtered chains, matched scene resets,
lockstep lanes, chain accounting, results.json — can be exercised end to end
with *nonzero* success rates and no simulator (reference workflow:
hulc/evaluation/evaluate_policy.py + calvin_env scripted-policy tooling).

The expert is deliberately host-side numpy (no torch): the point of an
expert-driven protocol run is to prove the evaluation pipeline's accounting
at scale, not the policy; it leaves the chip free.

Controller model: TCP moves at most 0.02/step in position (rel_actions
pos/50 integration) and 0.05 rad/step in yaw. Between manipulation sites it
travels at a transit height above every trigger/handle radius so subtasks
cannot contaminate each other. Residual grasps (a rotate/lift/unstack
succeeds the moment its scene predicate flips, possibly mid-grasp) are
detected at subtask start and released first when the new task needs an
empty gripper.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from hulc_tpu_torch.evaluation.chain_sampler import _DRAWER_POS, _SLOT_POS
from hulc_tpu_torch.evaluation.fake_env import (
    DRAWER_RANGE,
    GRASP_R,
    SLIDER_RANGE,
    BUTTON_SITE,
    SWITCH_SITE,
    TABLE_Z,
    drawer_handle,
    slider_handle,
    _BLOCK_SLICES,
)
from hulc_tpu_torch.evaluation.tasks import (
    ALL_TASKS,
    DOOR_TASKS,
    LIFT_TASKS,
    LIGHT_TASKS,
    PLACE_TASKS,
    PUSH_TASKS,
    ROTATE_TASKS,
)

TRANSIT_Z = 0.72
#: tasks whose script starts from an empty gripper (drop any residual grasp).
#: Door/light tasks are NOT here: they command grip=0 (keep) throughout, so a
#: residually-held block rides along for a later place/stack in the chain.
NEEDS_EMPTY = (
    set(ROTATE_TASKS) | set(PUSH_TASKS)
    | {t for t in LIFT_TASKS} | {"unstack_block", "push_into_drawer"}
)
_FREE_SPOTS = [(-0.10, 0.35), (0.05, 0.35), (0.20, 0.35), (-0.20, 0.30), (0.28, 0.30)]


def task_embeddings(dim: int, tasks=ALL_TASKS) -> Dict[str, np.ndarray]:
    """Distinct deterministic per-task embeddings (expert protocol runs use
    these in place of real MiniLM sentence embeddings — the expert only needs
    the instruction channel to carry task identity, like the reference's
    val-annotation embeddings do)."""
    if dim * dim < len(tasks):
        raise ValueError(f"dim {dim} too small for {len(tasks)} distinct tasks")
    out = {}
    for i, t in enumerate(sorted(tasks)):
        v = np.zeros(dim, np.float32)
        v[i % dim] = 1.0  # base-dim digit encoding: unique for i < dim^2
        v[(i // dim) % dim] += 0.25
        out[t] = v
    return out


def _clip_unit(x):
    return np.clip(x, -1.0, 1.0)


def _pos_action(tcp, target, gain=50.0):
    return _clip_unit((np.asarray(target) - tcp) * gain)


def _block_pos(scene, block):
    return scene[_BLOCK_SLICES[block]][:3]


def _wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def _action(pos=(0, 0, 0), yaw=0.0, grip=1.0):
    a = np.zeros(7, np.float32)
    a[:3] = pos
    a[5] = yaw
    a[6] = grip
    return a


class _Lane:
    """Per-lane script state: task + a phase machine over observed state."""

    def __init__(self, task: Optional[str]):
        self.task = task
        self.phase = 0
        self.start_scene: Optional[np.ndarray] = None
        self.grip = None  # last commanded gripper (None = not yet commanded)
        self.stage = 0  # approach sub-stage: 0 ascend, 1 translate, 2 descend
        self.target_block: Optional[str] = None
        self.drop_spot = None

    # -- generic transit approach -----------------------------------------
    def approach(self, tcp, target, grip) -> Optional[np.ndarray]:
        """Action toward ``target`` via transit height; None when arrived."""
        target = np.asarray(target, np.float32)
        xy_err = float(np.linalg.norm(target[:2] - tcp[:2]))
        if self.stage == 0:
            if xy_err < 0.02 or tcp[2] > TRANSIT_Z - 0.01:
                self.stage = 1
            else:
                return _action((0, 0, 1), grip=grip)
        if self.stage == 1:
            if xy_err < 0.008:
                self.stage = 2
            else:
                d = _pos_action(tcp, [target[0], target[1], max(tcp[2], TRANSIT_Z)])
                return _action(d, grip=grip)
        err = target - tcp
        if float(np.linalg.norm(err)) < 0.008:
            self.stage = 0  # re-arm for the next approach
            return None
        return _action(_pos_action(tcp, target), grip=grip)


class ScriptedExpertPolicy:
    """Batched scripted expert with the BatchedHulcPolicy driving surface.

    ``action_cap``/``noise`` shape the CONTINUOUS action channels (pos+orn;
    the discrete gripper channel is untouched) for demonstration collection:
    the raw scripts emit bang-bang saturated commands (exactly +-1), which
    are pathological training targets for the discretized-logistic head —
    the edge bins' likelihood is one-sided, so mixture means drift unbounded
    (sampled z-actions of ~50 were seen after training on saturated
    data). Real CALVIN teleop rarely saturates; cap 0.85 keeps every target
    interior to the act bounds and a small dither makes the data
    proportional-control-like. Defaults (1.0, 0.0) preserve the pure
    protocol-expert behavior."""

    def __init__(
        self,
        num_envs: int,
        lang_embeddings: Dict[str, np.ndarray],
        action_cap: float = 1.0,
        noise: float = 0.0,
        seed: int = 0,
    ):
        self.num_envs = num_envs
        self.replan_freq = 10**9  # replans only at subtask boundaries
        self.action_cap = action_cap
        self.noise = noise
        self._rng = np.random.default_rng(seed)
        self._emb_to_task = {
            np.asarray(v, np.float32).tobytes(): t for t, v in lang_embeddings.items()
        }

    def initial_state(self) -> List[_Lane]:
        return [_Lane(None) for _ in range(self.num_envs)]

    def step(self, obs_batch, lang_embs, state: List[_Lane], replan_mask):
        actions = np.zeros((self.num_envs, 7), np.float32)
        for i in range(self.num_envs):
            robot = np.asarray(obs_batch[i]["robot_obs"], np.float32)
            scene = np.asarray(obs_batch[i]["scene_obs"], np.float32)
            if replan_mask[i]:
                task = self._emb_to_task.get(
                    np.asarray(lang_embs[i], np.float32).tobytes()
                )
                state[i] = _Lane(task)
                state[i].start_scene = scene.copy()
                # residual grasp from the previous subtask?
                held = next(
                    (
                        b
                        for b in _BLOCK_SLICES
                        if np.linalg.norm(_block_pos(scene, b) - robot[:3]) < 0.005
                    ),
                    None,
                )
                if held is not None and robot[14] < 0:
                    if state[i].task in NEEDS_EMPTY:
                        state[i].phase = -1  # drop it first
                    elif state[i].task in PLACE_TASKS or state[i].task == "stack_block":
                        state[i].target_block = held  # already holding it
                    # door/light tasks carry it along (grip commands are 0)
            actions[i] = self._act(state[i], robot, scene)
        if self.action_cap < 1.0 or self.noise > 0.0:
            cont = actions[:, :6] * self.action_cap
            if self.noise > 0.0:
                cont = cont + self._rng.normal(0.0, self.noise, cont.shape)
            actions[:, :6] = np.clip(cont, -self.action_cap, self.action_cap)
        return actions, state

    # ------------------------------------------------------------------

    def _act(self, st: _Lane, robot, scene) -> np.ndarray:
        if st.task is None:
            return _action(grip=0.0)
        tcp = robot[:3]
        if st.phase == -1:  # release a residual grasp where it is, then go
            st.phase = 0
            return _action(grip=1.0)
        task = st.task
        if task in DOOR_TASKS:
            return self._act_door(st, tcp, scene)
        if task in LIGHT_TASKS:
            return self._act_light(st, tcp, scene)
        if task in ROTATE_TASKS:
            return self._act_rotate(st, tcp, scene)
        if task in PUSH_TASKS:
            return self._act_push(st, tcp, scene)
        if task in LIFT_TASKS:
            return self._act_lift(st, tcp, scene)
        if task in PLACE_TASKS:
            return self._act_place(st, tcp, scene)
        if task == "stack_block":
            return self._act_stack(st, tcp, scene)
        if task == "unstack_block":
            return self._act_unstack(st, tcp, scene)
        if task == "push_into_drawer":
            return self._act_push_into_drawer(st, tcp, scene)
        return _action(grip=0.0)

    # -- articulated -----------------------------------------------------
    def _act_door(self, st: _Lane, tcp, scene):
        if st.task == "move_slider_left":
            handle_fn, axis, joint_i = slider_handle, np.array([-1.0, 0, 0]), 0
        elif st.task == "move_slider_right":
            handle_fn, axis, joint_i = slider_handle, np.array([1.0, 0, 0]), 0
        elif st.task == "open_drawer":
            handle_fn, axis, joint_i = drawer_handle, np.array([0, -1.0, 0]), 1
        else:  # close_drawer
            handle_fn, axis, joint_i = drawer_handle, np.array([0, 1.0, 0]), 1
        handle = handle_fn(float(scene[joint_i]))  # tracks the live joint
        if st.phase == 0:
            a = st.approach(tcp, handle, grip=0.0)  # grip 0: keep (may carry)
            if a is not None:
                return a
            st.phase = 1
        return _action(axis, grip=0.0)

    def _act_light(self, st: _Lane, tcp, scene):
        site, light_i = (
            (BUTTON_SITE, 5) if st.task.endswith("led") else (SWITCH_SITE, 4)
        )
        want = 1.0 if st.task.startswith("turn_on") else 0.0
        if round(float(scene[light_i])) == want:
            # toggled: back straight off so we don't re-trigger
            return _action((0, 0, 1), grip=0.0)
        # the toggle is edge-triggered on ENTERING the radius: if we start
        # inside it (previous subtask toggled this same site), exit upward
        if st.phase == 0:
            if float(np.linalg.norm(tcp - site)) < 0.055:
                return _action((0, 0, 1), grip=0.0)
            st.phase = 1
        a = st.approach(tcp, site, grip=0.0)
        return a if a is not None else _action(grip=0.0)

    # -- blocks ------------------------------------------------------------
    def _grasp_then(self, st: _Lane, tcp, scene, block) -> Optional[np.ndarray]:
        """Phases 0-1: approach ``block`` open-gripper, close on it. Returns
        None once grasped (caller continues with its own phases >= 2)."""
        if st.phase == 0:
            a = st.approach(tcp, _block_pos(scene, block), grip=1.0)
            if a is not None:
                return a
            st.phase = 1
            return _action(grip=-1.0)  # closing transition in range = grasp
        if st.phase == 1:
            st.phase = 2
        return None

    def _act_rotate(self, st: _Lane, tcp, scene):
        # friction spin: closed gripper at the block, yaw the TCP — the block
        # never leaves the table, so its "table" contact survives into the
        # NEXT subtask's oracle start snapshot (a grasped rotate would poison
        # push-after-rotate chains)
        block, degrees = ROTATE_TASKS[st.task]
        if st.phase == 0:  # ascend open, close at transit height
            if tcp[2] < TRANSIT_Z - 0.01:
                return _action((0, 0, 1), grip=1.0)
            st.phase = 1
            return _action(grip=-1.0)
        if st.phase == 1:
            a = st.approach(tcp, _block_pos(scene, block), grip=-1.0)
            if a is not None:
                return a
            st.phase = 2
        dz = math.degrees(
            _wrap(float(_block_pos_full(scene, block)[5] - st.start_scene[_BLOCK_SLICES[block]][5]))
        )
        need = degrees + (8 if degrees > 0 else -8)
        if (degrees > 0 and dz < need) or (degrees < 0 and dz > need):
            return _action(yaw=1.0 if degrees > 0 else -1.0, grip=-1.0)
        return _action((0, 0, 1), grip=-1.0)  # clear out

    def _act_push(self, st: _Lane, tcp, scene):
        block, dx = PUSH_TASKS[st.task]
        if st.phase == 2:  # dragging
            moved = float(_block_pos(scene, block)[0] - st.start_scene[_BLOCK_SLICES[block]][0])
            if (dx > 0 and moved > dx + 0.04) or (dx < 0 and moved < dx - 0.04):
                return _action((0, 0, 1), grip=-1.0)  # clear of the block
            return _action((1.0 if dx > 0 else -1.0, 0, 0), grip=-1.0)
        # ascend OPEN (closing near a block would grasp it), close the gripper
        # at transit height, then approach closed (closed->closed never grasps)
        if st.phase == 0:
            if tcp[2] < TRANSIT_Z - 0.01:
                return _action((0, 0, 1), grip=1.0)
            st.phase = 1
            return _action(grip=-1.0)  # close, far from every block
        a = st.approach(tcp, _block_pos(scene, block), grip=-1.0)
        if a is not None:
            return a
        st.phase = 2
        return _action(grip=-1.0)

    def _act_lift(self, st: _Lane, tcp, scene):
        block, dz, _surf = LIFT_TASKS[st.task]
        a = self._grasp_then(st, tcp, scene, block)
        if a is not None:
            return a
        lifted = float(_block_pos(scene, block)[2] - st.start_scene[_BLOCK_SLICES[block]][2])
        if lifted < dz + 0.04:
            return _action((0, 0, 1), grip=-1.0)
        return _action(grip=-1.0)  # hold it (success requires "held")

    def _held_block(self, robot_tcp, scene) -> Optional[str]:
        return next(
            (
                b
                for b in _BLOCK_SLICES
                if np.linalg.norm(_block_pos(scene, b) - robot_tcp) < 0.005
            ),
            None,
        )

    def _act_place(self, st: _Lane, tcp, scene):
        if st.target_block is None:
            st.target_block = self._held_block(tcp, scene)
            if st.target_block is None:
                return _action(grip=0.0)  # nothing held: unrecoverable lane
        # release ABOVE the region box and let gravity drop the block in: a
        # held block that enters the box satisfies the place oracle while
        # still gripped (success mid-grasp poisons the NEXT subtask's start
        # snapshot with a "gripper" contact)
        if PLACE_TASKS[st.task] == "drawer":
            target = np.asarray([_DRAWER_POS[0], _DRAWER_POS[1], 0.445], np.float32)
        else:
            accessible = "slider_right" if scene[0] > 0.14 else "slider_left"
            slot = _SLOT_POS[accessible]
            target = np.asarray([slot[0], slot[1], 0.67], np.float32)
        if st.phase <= 1:
            a = st.approach(tcp, target, grip=-1.0)
            if a is not None:
                return a
            st.phase = 2
            return _action(grip=1.0)  # release: gravity rests it in the region
        return _action((0, 0, 1), grip=1.0)

    def _act_stack(self, st: _Lane, tcp, scene):
        if st.target_block is None:
            st.target_block = self._held_block(tcp, scene)
            if st.target_block is None:
                return _action(grip=0.0)
        base = next(
            (
                b
                for b in _BLOCK_SLICES
                if b != st.target_block
                and abs(_block_pos(scene, b)[2] - TABLE_Z) < 0.02
            ),
            None,
        )
        if base is None:
            return _action(grip=0.0)
        # release 0.10 above the base (outside the stacked-detection window,
        # so success can't fire while still gripped); gravity snaps it on top
        target = _block_pos(scene, base) + np.array([0, 0, 0.10], np.float32)
        if st.phase <= 1:
            a = st.approach(tcp, target, grip=-1.0)
            if a is not None:
                return a
            st.phase = 2
            return _action(grip=1.0)
        return _action((0, 0, 1), grip=1.0)

    def _act_unstack(self, st: _Lane, tcp, scene):
        # push the TOP block off the stack (no grasp: unstacking via grasp
        # succeeds mid-grip and poisons the next subtask's start snapshot);
        # gravity drops the pushed block onto the table beside the base
        if st.target_block is None:
            for top in _BLOCK_SLICES:
                for bot in _BLOCK_SLICES:
                    if top == bot:
                        continue
                    t, b = _block_pos(scene, top), _block_pos(scene, bot)
                    if np.linalg.norm(t[:2] - b[:2]) < 0.04 and 0.03 < t[2] - b[2] < 0.08:
                        st.target_block = top
            if st.target_block is None:
                return _action(grip=0.0)
        block = st.target_block
        if st.phase == 3:  # pushing it off
            others = [_block_pos(scene, b)[:2] for b in _BLOCK_SLICES if b != block]
            sep = min(float(np.linalg.norm(_block_pos(scene, block)[:2] - o)) for o in others)
            if sep > 0.08:
                return _action((0, 0, 1), grip=-1.0)  # clear: gravity takes it
            if st.drop_spot is None:
                st.drop_spot = next(
                    s
                    for s in _FREE_SPOTS
                    if all(np.linalg.norm(np.asarray(s) - o) > 0.12 for o in others)
                )
            d = np.asarray(st.drop_spot, np.float32) - tcp[:2]
            return _action(_clip_unit([d[0] * 50, d[1] * 50, 0.0]), grip=-1.0)
        if st.phase == 0:  # ascend open, close at transit height
            if tcp[2] < TRANSIT_Z - 0.01:
                return _action((0, 0, 1), grip=1.0)
            st.phase = 1
            return _action(grip=-1.0)
        a = st.approach(tcp, _block_pos(scene, block), grip=-1.0)
        if a is not None:
            return a
        st.phase = 3
        return _action(grip=-1.0)

    def _act_push_into_drawer(self, st: _Lane, tcp, scene):
        if st.target_block is None:
            st.target_block = next(
                (
                    b
                    for b in _BLOCK_SLICES
                    if abs(_block_pos(scene, b)[2] - TABLE_Z) < 0.02
                ),
                None,
            )
            if st.target_block is None:
                return _action(grip=0.0)
        block = st.target_block
        if float(_block_pos(scene, block)[2]) < 0.42:
            return _action((0, 0, 1), grip=-1.0)  # it fell in: clear out
        if st.drop_spot is None:
            # engage the block OFFSET away from its nearest neighbor so the
            # drag (radius PUSH_R around the TCP) doesn't sweep other blocks
            # into the drawer with it
            pos = _block_pos(scene, block)[:2]
            others = [
                _block_pos(scene, b)[:2] for b in _BLOCK_SLICES if b != block
            ]
            off = np.zeros(2, np.float32)
            if others:
                d, near = min((float(np.linalg.norm(pos - o)), o) for o in others)
                if d < 0.09:
                    off = (pos - near) / max(d, 1e-6) * 0.03
            st.drop_spot = off  # reused as the engagement offset
        off = st.drop_spot
        if st.phase == 2:  # drag toward the drawer opening center
            d = np.asarray([0.18 + off[0], 0.05 + off[1]], np.float32) - tcp[:2]
            a = _clip_unit(np.asarray([d[0], d[1], 0.0]) * 50)
            return _action(a, grip=-1.0)
        if st.phase == 0:  # ascend open, close at height (as in _act_push)
            if tcp[2] < TRANSIT_Z - 0.01:
                return _action((0, 0, 1), grip=1.0)
            st.phase = 1
            return _action(grip=-1.0)
        target = _block_pos(scene, block) + np.asarray([off[0], off[1], 0.0], np.float32)
        a = st.approach(tcp, target, grip=-1.0)
        if a is not None:
            return a
        st.phase = 2
        return _action(grip=-1.0)


def _block_pos_full(scene, block):
    return scene[_BLOCK_SLICES[block]]
