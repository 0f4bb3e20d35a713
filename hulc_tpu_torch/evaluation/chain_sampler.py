"""Feasibility-filtered instruction-chain sampler for LH-MTLC evaluation;
the port's copy of hulc_tpu/evaluation/chain_sampler.py, held against it
by tests/test_torch_eval_env.py.

Equivalent of the external ``calvin_agent.evaluation.multistep_sequences``
consumed by the reference at hulc/evaluation/evaluate_policy.py:7-10,82: the
CALVIN protocol evaluates 1000 chains of 5 *feasible* instructions — each
chain is valid under a symbolic model of the playtable (task preconditions +
effects over an abstract scene state), and every chain comes with the initial
scene configuration the simulator is reset to. Sampling uniformly over tasks
without this filter produces chains like
"close_drawer" with the drawer already closed, making avg_seq_len
incomparable to published numbers.

Abstract scene state (symbolic, not raw scene_obs):

    led        0 | 1                  (button-controlled green light)
    lightbulb  0 | 1                  (switch-controlled bulb)
    slider     "left" | "right"       (sliding cabinet door position)
    drawer     "open" | "closed"
    red_block / blue_block / pink_block:
               "table" | "slider_left" | "slider_right" | "drawer"
               | "grasped" | "stacked"
    grasped    0 | 1                  (is some block in the gripper)

Physical assumptions encoded in the rules (documented, testable):
  * a slider compartment is reachable only when the door is on the OTHER
    side (slider "left" exposes the right compartment and vice versa);
  * each slider compartment holds at most one block;
  * drawer interactions (lift from / place in / push into) need it open;
  * tabletop tasks (rotate/push/lift-from-table/stack base) need the block
    on the table and an empty gripper;
  * a chain never repeats a task (CALVIN protocol chains are distinct-task).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hulc_tpu_torch.evaluation.fake_env import FakeCalvinEnv

BLOCK_KEYS = ("red_block", "blue_block", "pink_block")
State = Dict[str, object]
Effect = Dict[str, object]
#: A rule maps a state to the list of alternative effects (empty = infeasible).
Rule = Callable[[State], List[Effect]]


def _accessible_slot(state: State) -> str:
    """The slider compartment exposed by the current door position."""
    return "slider_right" if state["slider"] == "left" else "slider_left"


def _blocks_at(state: State, where: str) -> List[str]:
    return [b for b in BLOCK_KEYS if state[b] == where]


def _grasped_block(state: State) -> Optional[str]:
    held = _blocks_at(state, "grasped")
    return held[0] if held else None


def _build_rules() -> Dict[str, Rule]:
    rules: Dict[str, Rule] = {}

    # -- tabletop manipulation (block stays on the table) -----------------
    def table_noop(block: str) -> Rule:
        def rule(s: State) -> List[Effect]:
            return [{}] if s[block] == "table" and s["grasped"] == 0 else []

        return rule

    for color in ("red", "blue", "pink"):
        block = f"{color}_block"
        for d in ("right", "left"):
            rules[f"rotate_{color}_block_{d}"] = table_noop(block)
            rules[f"push_{color}_block_{d}"] = table_noop(block)

    # -- articulated objects ----------------------------------------------
    def toggle(key: str, pre, post) -> Rule:
        return lambda s: [{key: post}] if s[key] == pre else []

    rules["move_slider_left"] = toggle("slider", "right", "left")
    rules["move_slider_right"] = toggle("slider", "left", "right")
    rules["open_drawer"] = toggle("drawer", "closed", "open")
    rules["close_drawer"] = toggle("drawer", "open", "closed")
    rules["turn_on_lightbulb"] = toggle("lightbulb", 0, 1)
    rules["turn_off_lightbulb"] = toggle("lightbulb", 1, 0)
    rules["turn_on_led"] = toggle("led", 0, 1)
    rules["turn_off_led"] = toggle("led", 1, 0)

    # -- lifting ------------------------------------------------------------
    def lift_from(block: str, where: Callable[[State], bool]) -> Rule:
        def rule(s: State) -> List[Effect]:
            if s["grasped"] == 0 and where(s):
                return [{block: "grasped", "grasped": 1}]
            return []

        return rule

    for color in ("red", "blue", "pink"):
        block = f"{color}_block"
        rules[f"lift_{color}_block_table"] = lift_from(
            block, lambda s, b=block: s[b] == "table"
        )
        rules[f"lift_{color}_block_slider"] = lift_from(
            block, lambda s, b=block: s[b] == _accessible_slot(s)
        )
        rules[f"lift_{color}_block_drawer"] = lift_from(
            block, lambda s, b=block: s[b] == "drawer" and s["drawer"] == "open"
        )

    # -- placing the held block --------------------------------------------
    def place_in_slider(s: State) -> List[Effect]:
        held = _grasped_block(s)
        slot = _accessible_slot(s)
        if held is not None and not _blocks_at(s, slot):
            return [{held: slot, "grasped": 0}]
        return []

    def place_in_drawer(s: State) -> List[Effect]:
        held = _grasped_block(s)
        if held is not None and s["drawer"] == "open":
            return [{held: "drawer", "grasped": 0}]
        return []

    rules["place_in_slider"] = place_in_slider
    rules["place_in_drawer"] = place_in_drawer

    # -- stacking -----------------------------------------------------------
    def stack_block(s: State) -> List[Effect]:
        held = _grasped_block(s)
        if held is not None and _blocks_at(s, "table"):
            return [{held: "stacked", "grasped": 0}]
        return []

    def unstack_block(s: State) -> List[Effect]:
        if s["grasped"] != 0:
            return []
        return [{b: "table"} for b in _blocks_at(s, "stacked")]

    rules["stack_block"] = stack_block
    rules["unstack_block"] = unstack_block

    # -- push a tabletop block into the open drawer --------------------------
    def push_into_drawer(s: State) -> List[Effect]:
        if s["drawer"] != "open" or s["grasped"] != 0:
            return []
        return [{b: "drawer"} for b in _blocks_at(s, "table")]

    rules["push_into_drawer"] = push_into_drawer
    return rules


TASK_RULES: Dict[str, Rule] = _build_rules()


def feasible_effects(state: State, task: str) -> List[Effect]:
    """Alternative effects of ``task`` in ``state`` ([] when infeasible)."""
    return TASK_RULES[task](state)


def apply_effect(state: State, effect: Effect) -> State:
    new = dict(state)
    new.update(effect)
    return new


def chain_is_feasible(initial_state: State, chain: Sequence[str]) -> bool:
    """Replay a chain symbolically (first feasible effect at each step)."""
    state = dict(initial_state)
    for task in chain:
        effects = feasible_effects(state, task)
        if not effects:
            return False
        state = apply_effect(state, effects[0])
    return True


def valid_initial_states() -> List[State]:
    """Enumerate the symbolic initial configurations the protocol draws from.

    Lights/doors are free booleans; block positions range over table and the
    two slider compartments (at most one block per compartment — the physical
    constraint of the cabinet); the gripper starts empty. Blocks never start
    in the drawer, grasped, or stacked (matching the CALVIN reset
    distribution, where those states are only reachable mid-chain).
    """
    states: List[State] = []
    block_positions = ("table", "slider_left", "slider_right")
    for led, bulb, slider, drawer in itertools.product(
        (0, 1), (0, 1), ("left", "right"), ("open", "closed")
    ):
        for placement in itertools.product(block_positions, repeat=3):
            if sum(p == "slider_left" for p in placement) > 1:
                continue
            if sum(p == "slider_right" for p in placement) > 1:
                continue
            states.append(
                {
                    "led": led,
                    "lightbulb": bulb,
                    "slider": slider,
                    "drawer": drawer,
                    "red_block": placement[0],
                    "blue_block": placement[1],
                    "pink_block": placement[2],
                    "grasped": 0,
                }
            )
    return states


def get_sequences(
    num_sequences: int = 1000,
    seed: int = 0,
    chain_len: int = 5,
    tasks: Optional[Sequence[str]] = None,
) -> List[Tuple[State, List[str]]]:
    """Deterministic feasibility-filtered (initial_state, chain) set.

    Within each chain, every task is feasible given the symbolic state left
    by its predecessors and no task repeats. Across chains, tasks are drawn
    with inverse-frequency weights so the 1000-chain set covers the task
    inventory near-uniformly (the balancing the CALVIN protocol set has).
    """
    pool = list(tasks) if tasks is not None else sorted(TASK_RULES)
    unknown = [t for t in pool if t not in TASK_RULES]
    if unknown:
        raise ValueError(f"tasks without feasibility rules: {unknown}")
    rng = np.random.default_rng(seed)
    initial_states = valid_initial_states()
    counts = {t: 0 for t in pool}
    out: List[Tuple[State, List[str]]] = []
    attempts = 0
    max_attempts = 200 * num_sequences
    while len(out) < num_sequences:
        attempts += 1
        if attempts > max_attempts:
            raise RuntimeError(
                f"chain sampling dead-ends too often for pool {pool!r} "
                f"(got {len(out)}/{num_sequences}); use a richer task pool"
            )
        initial = dict(initial_states[rng.integers(len(initial_states))])
        state = dict(initial)
        chain: List[str] = []
        for _ in range(min(chain_len, len(pool))):
            feasible = [t for t in pool if t not in chain and feasible_effects(state, t)]
            if not feasible:
                break
            weights = np.asarray([1.0 / (1.0 + counts[t]) for t in feasible])
            task = feasible[rng.choice(len(feasible), p=weights / weights.sum())]
            effects = feasible_effects(state, task)
            # canonical (first) effect: for multi-effect tasks (push_into_
            # drawer / unstack with a choice of blocks) the chain's
            # continuation must match what a deterministic agent would pick —
            # a randomly-chosen alternative makes chains like
            # push_into_drawer -> lift_pink_block_drawer unfair to ANY agent
            # that can't see the sampler's private coin
            state = apply_effect(state, effects[0])
            chain.append(task)
        if len(chain) < min(chain_len, len(pool)):
            continue  # dead end: resample the whole sequence
        for t in chain:
            counts[t] += 1
        out.append((initial, chain))
    return out


# ---------------------------------------------------------------------------
# Symbolic state -> concrete reset vectors
# ---------------------------------------------------------------------------

#: scene_obs layout (tasks.py): [slider, drawer, button, switch, lightbulb,
#: green_light(led), red_block(6), blue_block(6), pink_block(6)]
_BLOCK_OBS_SLICES = {"red_block": slice(6, 12), "blue_block": slice(12, 18), "pink_block": slice(18, 24)}
_SLIDER_JOINT = {"right": 0.0, "left": 0.28}
_DRAWER_JOINT = {"closed": 0.0, "open": 0.22}
#: nominal positions consistent with the SceneObsTasks region boxes
_TABLE_SPOTS = ((-0.10, 0.35, 0.46), (0.05, 0.35, 0.46), (0.20, 0.35, 0.46))
_SLOT_POS = {"slider_left": (-0.28, 0.10, 0.55), "slider_right": (0.02, 0.10, 0.55)}
_DRAWER_POS = (0.18, 0.05, 0.36)
_STACK_DZ = 0.05


def resets_for_env(pairs, env):
    """Per-chain (robot_obs, scene_obs) reset vectors appropriate for ``env``.

    Real calvin_env adapters expose ``get_env_state_for_initial_condition``
    (the calvin_agent hook) — symbolic states go through it so the simulator
    samples physically consistent resets. The built-in FakeCalvinEnv gets
    the nominal-geometry vectors from :func:`initial_state_to_obs`. Unknown
    envs get ``None`` (self-chosen resets) with a warning, because feeding
    them fake-geometry vectors silently corrupts the protocol.
    """
    hook = getattr(env, "get_env_state_for_initial_condition", None)
    if hook is not None:
        return [hook(dict(state)) for state, _ in pairs]
    if env is None or isinstance(env, FakeCalvinEnv):
        return [initial_state_to_obs(state) for state, _ in pairs]
    print(
        "[chain_sampler] env has no get_env_state_for_initial_condition; "
        "chains will run from env-chosen resets (not the matched initial states)"
    )
    return None


def initial_state_to_obs(state: State) -> Tuple[np.ndarray, np.ndarray]:
    """(robot_obs(15,), scene_obs(24,)) concrete reset vectors for a symbolic
    state, laid out for the scene_obs-driven oracle/env contract (tasks.py).
    With the real calvin_env, use its own get_env_state_for_initial_condition
    through the adapter instead."""
    scene = np.zeros(24, np.float32)
    scene[0] = _SLIDER_JOINT[str(state["slider"])]
    scene[1] = _DRAWER_JOINT[str(state["drawer"])]
    scene[2] = float(state["led"])  # button joint mirrors the led state
    scene[3] = float(state["lightbulb"])  # switch mirrors the bulb state
    scene[4] = float(state["lightbulb"])
    scene[5] = float(state["led"])
    table_i = 0
    stack_h = 0
    for block in BLOCK_KEYS:
        pos = state[block]
        sl = _BLOCK_OBS_SLICES[block]
        if pos in _SLOT_POS:
            scene[sl][:3] = _SLOT_POS[pos]
        elif pos == "drawer":
            scene[sl][:3] = _DRAWER_POS
        elif pos == "stacked":
            scene[sl][:3] = np.add(_TABLE_SPOTS[0], (0, 0, _STACK_DZ * (stack_h + 1)))
            stack_h += 1
        else:  # table (also the fallback for grasped, which never occurs at reset)
            scene[sl][:3] = _TABLE_SPOTS[table_i % len(_TABLE_SPOTS)]
            table_i += 1
    robot = np.zeros(15, np.float32)
    robot[:3] = (0.0, 0.2, 0.6)  # neutral TCP above the table
    robot[14] = 1.0  # gripper open
    return robot, scene
