"""Oracle (shortest-path) trajectory generator for supervised training.

A copy of ``jolineedle_tpu/env/oracle.py`` (numpy only), which gives the same
arrays for the same ``np.random.Generator``. Host-side: pure bbox/grid
geometry run once per sample on tiny sets, so it belongs in the input
pipeline. It emits positions, actions and masks; patch *pixels* are
gathered afterwards (``gather_patches``, vectorized slicing on the host).

Behavioral parity with the reference ``NeedleSimpleEnv`` oracle (reference:
src/env/simple_env.py:166-763):
  - bbox patches = patches covered >5% by a box, plus the center patch
    (simple_env.py:270-321);
  - greedy nearest-unvisited-keypoint ordering with random tie-breaks
    (simple_env.py:590-629);
  - random keypoint insertion, uniform or binomial-around-target, with
    next-action labels always pointing at the *true* target
    (simple_env.py:545-567, 666-713);
  - STOP is never labeled; on-target labels are replaced by a random move
    (simple_env.py:715-718);
  - over-long episodes keep their *tail* (simple_env.py:573-584).
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np

from .actions import ACTION_DELTAS, Action, MOVES
from .parsing import bbox_patch_positions


def move_towards(current: Tuple[int, int], target: Tuple[int, int]) -> Action:
    """Greedy compass move from ``current`` to ``target`` in (y, x) patch
    coords; STOP when already there (reference: src/env/simple_env.py:84-125)."""
    gy = target[0] - current[0]
    gx = target[1] - current[1]
    if gy > 0 and gx == 0:
        return Action.DOWN
    if gy < 0 and gx == 0:
        return Action.UP
    if gx > 0 and gy == 0:
        return Action.RIGHT
    if gx < 0 and gy == 0:
        return Action.LEFT
    if gy < 0 and gx > 0:
        return Action.RIGHT_UP
    if gy < 0 and gx < 0:
        return Action.LEFT_UP
    if gy > 0 and gx > 0:
        return Action.RIGHT_DOWN
    if gy > 0 and gx < 0:
        return Action.LEFT_DOWN
    return Action.STOP


class OracleEnv:
    """Single-image patch-grid environment for oracle generation.

    Pixel-free: only grid geometry; ``bboxes`` is ``[n, 4]`` pixel xyxy.
    """

    def __init__(
        self,
        image_hw: Tuple[int, int],
        patch_size: int,
        bboxes: np.ndarray,
        rng: Optional[np.random.Generator] = None,
    ):
        self.height, self.width = int(image_hw[0]), int(image_hw[1])
        self.patch_size = int(patch_size)
        assert self.height % self.patch_size == 0
        assert self.width % self.patch_size == 0
        self.patch_height = self.height // self.patch_size
        self.patch_width = self.width // self.patch_size
        self.rng = rng if rng is not None else np.random.default_rng()
        self.raw_bboxes = np.asarray(bboxes, dtype=np.float64).reshape(-1, 4)

        self.bbox_patches: Set[Tuple[int, int]] = set()
        for box in self.raw_bboxes:
            self.bbox_patches |= bbox_patch_positions(
                box, self.patch_size, self.patch_height, self.patch_width
            )

        self.position = (0, 0)
        self.visited_bbox_patches: Set[Tuple[int, int]] = set()

    # --- core mechanics ----------------------------------------------------
    def reset(
        self,
        position: Optional[Tuple[int, int]] = None,
        visited: Optional[Set[Tuple[int, int]]] = None,
    ):
        if position is None:
            position = (
                int(self.rng.integers(0, self.patch_height)),
                int(self.rng.integers(0, self.patch_width)),
            )
        self.position = (int(position[0]), int(position[1]))
        self.visited_bbox_patches = set() if visited is None else set(visited)
        if self.position in self.bbox_patches:
            self.visited_bbox_patches.add(self.position)

    def step(self, action: Action):
        dy, dx = ACTION_DELTAS[action]
        y = min(max(self.position[0] + dy, 0), self.patch_height - 1)
        x = min(max(self.position[1] + dx, 0), self.patch_width - 1)
        self.position = (y, x)
        if self.position in self.bbox_patches:
            self.visited_bbox_patches.add(self.position)

    def local_bboxes(self, position: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Per-box overlap with the patch at ``position``, in local coords.

        Rows: (cls=0, x1, y1, x2, y2, objectness). Exclusive bottom-right
        convention, matching reference src/env/simple_env.py:231-268.
        """
        if position is None:
            position = self.position
        n = len(self.raw_bboxes)
        out = np.zeros((n, 6), dtype=np.float32)
        py, px = position
        x1p, y1p = px * self.patch_size, py * self.patch_size
        x2p, y2p = x1p + self.patch_size, y1p + self.patch_size
        for i, (bx1, by1, bx2, by2) in enumerate(self.raw_bboxes):
            x1 = max(x1p, bx1)
            y1 = max(y1p, by1)
            x2 = min(x2p, bx2)
            y2 = min(y2p, by2)
            if x1 < x2 and y1 < y2:
                out[i] = [0, x1 - x1p, y1 - y1p, x2 - x1p, y2 - y1p, 1]
        return out

    # --- oracle helpers ----------------------------------------------------
    @staticmethod
    def cap_local_bboxes(local: np.ndarray, cap: int) -> np.ndarray:
        """Cap ``local_bboxes`` rows to ``cap``, keeping real targets.

        Rows with objectness==1 are moved to the front (stable) before
        slicing — a raw-index slice could drop a patch's only overlapping
        box while keeping zero padding rows whenever the image holds more
        than ``cap`` boxes."""
        order = np.argsort(-local[:, 5], kind="stable")
        return local[order][:cap]

    def remove_stop_action(self, action: Action) -> Action:
        if action == Action.STOP:
            return self.rng.choice(MOVES)
        return action

    def generate_keypoints(self, n: int) -> List[Tuple[int, int]]:
        return [
            (
                int(self.rng.integers(0, self.patch_height)),
                int(self.rng.integers(0, self.patch_width)),
            )
            for _ in range(n)
        ]

    def generate_binomial_keypoints(
        self, n: int, target: Tuple[int, int]
    ) -> List[Tuple[int, int]]:
        """Binomial displacement around the target, wrapping at the borders
        (reference: src/env/simple_env.py:684-713)."""
        out = []
        for _ in range(n):
            x = int(self.rng.binomial(self.patch_width, 0.5)) - self.patch_width // 2
            y = int(self.rng.binomial(self.patch_height, 0.5)) - self.patch_height // 2
            out.append(
                (
                    (target[0] + y) % self.patch_height,
                    (target[1] + x) % self.patch_width,
                )
            )
        return out

    def build_keypoints_trajectory(self) -> List[Tuple[int, int]]:
        """Greedy nearest-unvisited bbox-patch ordering with random
        tie-breaks (reference: src/env/simple_env.py:590-629)."""
        to_visit = set(self.bbox_patches) - self.visited_bbox_patches
        keypoints = []
        current = self.position
        while to_visit:
            best, min_dist = [], float("inf")
            # Sort for determinism under a fixed rng (the reference iterates
            # a Python set, whose order is arbitrary but fixed per run).
            for pos in sorted(to_visit):
                dist = abs(pos[1] - current[1]) + abs(pos[0] - current[0])
                if dist < min_dist:
                    min_dist = dist
                    best = []
                if dist == min_dist:
                    best.append(pos)
            pick = best[int(self.rng.integers(0, len(best)))]
            keypoints.append(pick)
            to_visit.remove(pick)
            current = pick
        if not keypoints:
            keypoints.append(self.generate_keypoints(1)[0])
        return keypoints


def generate_sample(
    env: OracleEnv,
    max_ep_len: int,
    min_keypoints: int,
    max_keypoints: int,
    binomial_keypoints: bool = False,
    position: Optional[Tuple[int, int]] = None,
    visited: Optional[Set[Tuple[int, int]]] = None,
    max_boxes: Optional[int] = None,
) -> dict:
    """Generate one oracle episode as fixed-shape numpy arrays.

    Returns a dict with keys (T = max_ep_len, N = box cap):
        positions        [T, 2] int32 (y, x) patch coords
        current_actions  [T]    int32 action taken to *enter* each patch
        next_actions     [T]    int32 best action label at each patch
        labels           [T]    int32 1 if the patch contains a box
        masks            [T]    float32 episode-validity mask
        local_bboxes     [T, N, 6] float32 (cls, xyxy local, obj)

    Parity with reference src/env/simple_env.py:481-664, minus pixels (the
    patch pixels are gathered from positions afterwards).
    """
    env.reset(position, visited)

    records = []  # (action_taken, position, best_action)

    def add_record(action_taken: Action, best_action: Action):
        records.append([action_taken.value, env.position, best_action.value])

    add_record(Action.LEFT, Action.LEFT)

    keypoints = env.build_keypoints_trajectory()
    n_keypoints = int(env.rng.integers(min_keypoints, max_keypoints + 1))
    insert_at = list(
        sorted(
            env.rng.integers(0, len(keypoints), size=n_keypoints).tolist(),
            reverse=True,
        )
    )

    def visit_point(to_visit, true_target):
        while env.position != to_visit:
            action = move_towards(env.position, to_visit)
            env.step(action)
            best = env.remove_stop_action(move_towards(env.position, true_target))
            add_record(action, best)

    for kid, keypoint in enumerate(keypoints):
        # Replace the previous step's label by the best action toward the
        # next keypoint (reference: src/env/simple_env.py:545-552).
        prev_best = env.remove_stop_action(move_towards(env.position, keypoint))
        records[-1][2] = prev_best.value

        while kid in insert_at:
            if binomial_keypoints:
                random_kp = env.generate_binomial_keypoints(1, keypoint)[0]
            else:
                random_kp = env.generate_keypoints(1)[0]
            visit_point(random_kp, keypoint)
            insert_at.remove(kid)

        visit_point(keypoint, keypoint)

    # Truncation keeps the tail (reference: src/env/simple_env.py:573-584).
    if len(records) > max_ep_len:
        records = records[len(records) - max_ep_len :]

    T = max_ep_len
    n_boxes = len(env.raw_bboxes) if max_boxes is None else max_boxes
    sample = {
        "positions": np.zeros((T, 2), np.int32),
        "current_actions": np.zeros((T,), np.int32),
        "next_actions": np.zeros((T,), np.int32),
        "labels": np.zeros((T,), np.int32),
        "masks": np.zeros((T,), np.float32),
        "local_bboxes": np.zeros((T, n_boxes, 6), np.float32),
    }
    for i, (action_taken, pos, best) in enumerate(records):
        sample["positions"][i] = pos
        sample["current_actions"][i] = action_taken
        sample["next_actions"][i] = best
        sample["labels"][i] = int(tuple(pos) in env.bbox_patches)
        sample["masks"][i] = 1.0
        local = env.cap_local_bboxes(env.local_bboxes(pos), n_boxes)
        sample["local_bboxes"][i, : len(local)] = local
    return sample


def detection_patch_positions(
    env: OracleEnv, max_patches: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Positions of the YOLOX training patches for one image: all bbox
    patches plus one random empty patch (reference:
    src/env/simple_env.py:397-440).

    Returns (positions [K, 2] int32, valid [K] bool), fixed K if
    ``max_patches`` given.
    """
    positions = set(env.bbox_patches)  # built once in __init__
    n_total = env.patch_height * env.patch_width
    negative = None
    if len(positions) < n_total:
        # One random empty patch.
        empties = [
            (y, x)
            for y in range(env.patch_height)
            for x in range(env.patch_width)
            if (y, x) not in positions
        ]
        negative = empties[int(env.rng.integers(0, len(empties)))]

    pos_list = sorted(positions)
    if max_patches is not None:
        # Cap WITHOUT losing the guaranteed negative: keep it, and
        # rng-subsample the positives into the remaining slots (a plain
        # sorted slice would scan-bias toward the top-left and could drop
        # the one empty patch this function exists to include).
        keep = max_patches - (1 if negative is not None else 0)
        if len(pos_list) > keep:
            idx = env.rng.choice(len(pos_list), size=keep, replace=False)
            pos_list = [pos_list[i] for i in sorted(idx)]
        if negative is not None:
            pos_list.append(negative)
        k = max_patches
    else:
        if negative is not None:
            pos_list.append(negative)
        k = max(len(pos_list), 1)
    out = np.zeros((k, 2), np.int32)
    valid = np.zeros((k,), bool)
    for i, p in enumerate(pos_list):
        out[i] = p
        valid[i] = True
    return out, valid


def gather_patches(image: np.ndarray, positions: np.ndarray, patch_size: int):
    """Vectorized host-side patch pixel gather.

    ``image`` is [H, W, C]; ``positions`` is [K, 2] (y, x) patch coords.
    Returns [K, P, P, C].
    """
    h, w, c = image.shape
    nv, nh = h // patch_size, w // patch_size
    tiled = image.reshape(nv, patch_size, nh, patch_size, c).transpose(0, 2, 1, 3, 4)
    return tiled[positions[:, 0], positions[:, 1]]
