"""Task-success oracle for the CALVIN playtable (34 tasks); the port's
copy of hulc_tpu/evaluation/tasks.py, held against it by
tests/test_torch_eval_env.py.

Reimplements the behavior of the external ``calvin_env.envs.tasks.Tasks``
(reference conf/callbacks/rollout/tasks/new_playtable_tasks.yaml — task list
and thresholds taken from that config). The reference oracle inspects
PyBullet state dicts (object poses + contact lists); this one is driven by
the ``info`` dict contract our env wrappers emit:

    info = {
        "scene_obs": (24,) float array  [slider, drawer, button, switch,
            lightbulb, green_light, red_block(6), blue_block(6),
            pink_block(6)],
        "block_contacts": {"block_red": ["table" | "plank" | "drawer" |
            "gripper" | "block_*", ...], ...}   (optional; position-derived
            fallbacks are used when absent)
    }

With the real calvin_env you can instead pass its own Tasks object to the
evaluator — the interface (``get_task_info_for_set``) matches.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

BLOCKS = ("block_red", "block_blue", "block_pink")
_BLOCK_SLICES = {"block_red": slice(6, 12), "block_blue": slice(12, 18), "block_pink": slice(18, 24)}

# Nominal playtable regions (x, y, z) boxes for the position-derived
# containment fallbacks. Heights are deliberately disjoint from the table
# surface (z=0.46) so region classification is unambiguous.
DRAWER_BOX = ((0.0, 0.35), (-0.1, 0.2), (0.30, 0.42))
SLIDER_BOX = ((-0.35, 0.1), (-0.05, 0.25), (0.50, 0.65))
TABLE_Z = 0.46

# Task table mirrored from new_playtable_tasks.yaml.
ROTATE_TASKS = {
    f"rotate_{c}_block_{d}": (f"block_{c}", -60 if d == "right" else 60)
    for c in ("red", "blue", "pink")
    for d in ("right", "left")
}
PUSH_TASKS = {
    f"push_{c}_block_{d}": (f"block_{c}", 0.1 if d == "right" else -0.1)
    for c in ("red", "blue", "pink")
    for d in ("right", "left")
}
DOOR_TASKS = {
    "move_slider_left": (0, 0.15),
    "move_slider_right": (0, -0.15),
    "open_drawer": (1, 0.12),
    "close_drawer": (1, -0.12),
}
LIFT_TASKS = {
    f"lift_{c}_block_{surf}": (f"block_{c}", {"table": 0.05, "slider": 0.03, "drawer": 0.05}[surf], surf)
    for c in ("red", "blue", "pink")
    for surf in ("table", "slider", "drawer")
}
LIGHT_TASKS = {
    "turn_on_lightbulb": (4, 0, 1),
    "turn_off_lightbulb": (4, 1, 0),
    "turn_on_led": (5, 0, 1),
    "turn_off_led": (5, 1, 0),
}
PLACE_TASKS = {"place_in_slider": "slider", "place_in_drawer": "drawer"}

ALL_TASKS: List[str] = (
    list(ROTATE_TASKS)
    + list(PUSH_TASKS)
    + list(DOOR_TASKS)
    + list(LIFT_TASKS)
    + list(PLACE_TASKS)
    + ["stack_block", "unstack_block"]
    + list(LIGHT_TASKS)
    + ["push_into_drawer"]
)


def _block_state(scene_obs: np.ndarray, block: str) -> np.ndarray:
    return np.asarray(scene_obs)[_BLOCK_SLICES[block]]


def _in_box(pos: np.ndarray, box) -> bool:
    return all(lo <= p <= hi for p, (lo, hi) in zip(pos, box))


def _wrap_deg(d: float) -> float:
    return (d + 180.0) % 360.0 - 180.0


class SceneObsTasks:
    """scene_obs-diff task oracle with the calvin_env Tasks interface.

    The containment region boxes default to the nominal playtable values
    above; pass ``regions`` (or use :meth:`from_calibration`) to use boxes
    derived from real dataset traces (the JAX package's
    ``evaluation/calibrate_oracle.py`` writes such a file).
    """

    def __init__(
        self,
        tasks: Optional[Sequence[str]] = None,
        regions: Optional[Dict] = None,
    ):
        self.tasks = list(tasks) if tasks is not None else list(ALL_TASKS)
        regions = regions or {}
        self.drawer_box = tuple(tuple(b) for b in regions.get("drawer_box", DRAWER_BOX))
        self.slider_box = tuple(tuple(b) for b in regions.get("slider_box", SLIDER_BOX))
        self.table_z = float(regions.get("table_z", TABLE_Z))
        self.table_z_tol = float(regions.get("table_z_tol", 0.02))

    @classmethod
    def from_calibration(cls, path, tasks: Optional[Sequence[str]] = None) -> "SceneObsTasks":
        """Oracle with region boxes loaded from a calibrate_oracle JSON."""
        import json
        import pathlib

        return cls(tasks=tasks, regions=json.loads(pathlib.Path(path).read_text()))

    # calvin_env.envs.tasks.Tasks API surface
    def get_task_info(self, start_info: Dict, end_info: Dict) -> Set[str]:
        return self.get_task_info_for_set(start_info, end_info, set(self.tasks))

    def get_task_info_for_set(
        self, start_info: Dict, end_info: Dict, task_filter: Iterable[str]
    ) -> Set[str]:
        done = set()
        for task in task_filter:
            if task in self.tasks and self._check(task, start_info, end_info):
                done.add(task)
        return done

    # ------------------------------------------------------------------

    def _contacts(self, info: Dict, block: str) -> Set[str]:
        contacts = info.get("block_contacts")
        if contacts is not None:
            return set(contacts.get(block, ()))
        # position-derived fallback
        s = _block_state(info["scene_obs"], block)
        pos = s[:3]
        out = set()
        if _in_box(pos, self.drawer_box):
            out.add("drawer")
        elif _in_box(pos, self.slider_box):
            out.add("plank")
        elif abs(pos[2] - self.table_z) < self.table_z_tol:
            out.add("table")
        return out

    def _check(self, task: str, start: Dict, end: Dict) -> bool:
        s_obs = np.asarray(start["scene_obs"], np.float64)
        e_obs = np.asarray(end["scene_obs"], np.float64)

        if task in DOOR_TASKS:
            idx, thresh = DOOR_TASKS[task]
            diff = e_obs[idx] - s_obs[idx]
            return diff > thresh if thresh > 0 else diff < thresh

        if task in LIGHT_TASKS:
            idx, v0, v1 = LIGHT_TASKS[task]
            return round(s_obs[idx]) == v0 and round(e_obs[idx]) == v1

        if task in ROTATE_TASKS:
            block, degrees = ROTATE_TASKS[task]
            s_b, e_b = _block_state(s_obs, block), _block_state(e_obs, block)
            dz = _wrap_deg(math.degrees(e_b[5] - s_b[5]))
            # x/y rotation must stay small (yaml x_y_threshold=30 deg)
            dxy = max(abs(_wrap_deg(math.degrees(e_b[3] - s_b[3]))),
                      abs(_wrap_deg(math.degrees(e_b[4] - s_b[4]))))
            ok = dz < degrees if degrees < 0 else dz > degrees
            return ok and dxy < 30.0

        if task in PUSH_TASKS:
            block, dx = PUSH_TASKS[task]
            s_b, e_b = _block_state(s_obs, block), _block_state(e_obs, block)
            moved = e_b[0] - s_b[0]
            started_on_table = "table" in self._contacts(start, block)
            ends_supported = len(self._contacts(end, block)) > 0
            ok = moved > dx if dx > 0 else moved < dx
            return ok and started_on_table and ends_supported

        if task in LIFT_TASKS:
            block, dz, surf = LIFT_TASKS[task]
            s_b, e_b = _block_state(s_obs, block), _block_state(e_obs, block)
            surf_contact = {"table": "table", "slider": "plank", "drawer": "drawer"}[surf]
            started_there = surf_contact in self._contacts(start, block)
            lifted = (e_b[2] - s_b[2]) > dz
            held = "gripper" in self._contacts(end, block) or len(self._contacts(end, block)) == 0
            return started_there and lifted and held

        if task in PLACE_TASKS:
            box = self.drawer_box if PLACE_TASKS[task] == "drawer" else self.slider_box
            for block in BLOCKS:
                was_held = "gripper" in self._contacts(start, block)
                now_in = _in_box(_block_state(e_obs, block)[:3], box)
                if was_held and now_in:
                    return True
            return False

        if task == "push_into_drawer":
            for block in BLOCKS:
                s_b, e_b = _block_state(s_obs, block), _block_state(e_obs, block)
                started_table = "table" in self._contacts(start, block)
                now_in = _in_box(e_b[:3], self.drawer_box) or "drawer" in self._contacts(end, block)
                if started_table and now_in and "gripper" not in self._contacts(end, block):
                    return True
            return False

        if task in ("stack_block", "unstack_block"):
            def stacked(info):
                obs = np.asarray(info["scene_obs"], np.float64)
                for top in BLOCKS:
                    for bot in BLOCKS:
                        if top == bot:
                            continue
                        t, b = _block_state(obs, top), _block_state(obs, bot)
                        if (
                            np.linalg.norm(t[:2] - b[:2]) < 0.04
                            and 0.03 < (t[2] - b[2]) < 0.08
                        ):
                            return (top, bot)
                return None

            before, after = stacked(start), stacked(end)
            if task == "stack_block":
                return before is None and after is not None
            return before is not None and after is None

        raise KeyError(f"unknown task {task!r}")
