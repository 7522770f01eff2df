"""Core datatypes of the port: tile/object kinds, EnvConfig, MapArrays.

Counterpart of dtown/types.py. ``EnvConfig`` keeps the reference's field
names and defaults; ``MapArrays`` holds numpy arrays (the map compiler's
output) and moves to a torch device with ``.to(device)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simbench.reference.frozen import constants as C

# --- Tile kinds ----------------------------------------------------------
TILE_EMPTY = 0
TILE_STRAIGHT = 1
TILE_CURVE_LEFT = 2
TILE_CURVE_RIGHT = 3
TILE_3WAY_LEFT = 4
TILE_3WAY_RIGHT = 5
TILE_4WAY = 6
TILE_ASPHALT = 7
TILE_GRASS = 8
TILE_FLOOR = 9

TILE_KINDS = {
    "empty": TILE_EMPTY,
    "straight": TILE_STRAIGHT,
    "curve_left": TILE_CURVE_LEFT,
    "curve_right": TILE_CURVE_RIGHT,
    "3way_left": TILE_3WAY_LEFT,
    "3way_right": TILE_3WAY_RIGHT,
    "4way": TILE_4WAY,
    "asphalt": TILE_ASPHALT,
    "grass": TILE_GRASS,
    "floor": TILE_FLOOR,
}
TILE_KIND_NAMES = {v: k for k, v in TILE_KINDS.items()}
DRIVABLE_KINDS = (
    TILE_STRAIGHT, TILE_CURVE_LEFT, TILE_CURVE_RIGHT,
    TILE_3WAY_LEFT, TILE_3WAY_RIGHT, TILE_4WAY,
)

# --- Object kinds ----------------------------------------------------------
OBJ_KINDS = [
    "duckie", "duckiebot", "cone", "barrier", "tree", "house", "truck",
    "bus", "building", "sign_stop", "sign_T_intersect", "sign_yield",
    "sign_left_T_intersect", "sign_right_T_intersect",
    "sign_4_way_intersect", "sign_do_not_enter", "sign_oneway_left",
    "sign_oneway_right", "sign_duck_crossing", "sign_pedestrian",
    "trafficlight",
]
OBJ_KIND_IDS = {k: i for i, k in enumerate(OBJ_KINDS)}


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (same fields and defaults as
    dtown.types.EnvConfig; see there for each field's meaning)."""

    # Observation
    obs_type: str = "rgb"
    camera_width: int = 64
    camera_height: int = 64
    grayscale: bool = False
    render_objects: bool = True
    max_visible_objects: int = 8
    obj_cull_dist: float = 4.0
    obj_lod_px: float = 2.0
    marking_aa: bool = True
    renderer: str = "xla"
    distortion: bool = False
    mesh_fidelity: str = "prims"

    # Episode handling
    auto_reset: bool = True

    # Dynamics
    frame_skip: int = C.DEFAULT_FRAME_SKIP
    frame_rate: int = C.DEFAULT_FRAMERATE
    max_steps: int = C.DEFAULT_MAX_STEPS
    robot_speed: float = C.DEFAULT_ROBOT_SPEED

    # Wheel-model inverse kinematics
    use_wheel_model: bool = True
    gain: float = C.DEFAULT_GAIN
    trim: float = C.DEFAULT_TRIM
    wheel_radius: float = C.DEFAULT_WHEEL_RADIUS
    k: float = C.DEFAULT_K
    limit: float = C.DEFAULT_LIMIT

    # Reset / spawn
    domain_rand: bool = False
    accept_start_angle_deg: float = C.DEFAULT_ACCEPT_START_ANGLE_DEG
    spawn_mode: str = "bank"
    spawn_attempts: int = 32
    user_tile_start: tuple | None = None
    start_pose: tuple | None = None

    # Debug overlays
    draw_curve: bool = False
    draw_bbox: bool = False

    # Extended per-step info
    full_transparency: bool = False

    # Reward
    collision_termination: bool = True
    nav_shaping_coef: float = 0.0

    @property
    def delta_time(self) -> float:
        return 1.0 / self.frame_rate

    @property
    def obs_channels(self) -> int:
        return 1 if self.grayscale else 3


MAP_FIELDS = (
    "tile_kind", "tile_angle", "drivable", "tile_tex", "curves",
    "curve_mask", "obj_pos", "obj_y_rot", "obj_scale", "obj_kind",
    "obj_corners", "obj_norms", "obj_safety_rad", "obj_height",
    "obj_halfdims", "obj_mask", "obj_optional", "obj_is_dynamic",
    "obj_walk_dist", "tile_size", "drivable_frac", "spawn_pos",
    "spawn_angle", "spawn_lane_deg", "spawn_mask",
)


@dataclasses.dataclass(frozen=True, eq=False)
class MapArrays:
    """Compiled static map data (numpy arrays, or tensors after
    ``.to(device)``). Shapes and dtypes as in dtown.types.MapArrays:
    int32 tile grids [H, W], bool masks, float32 everything else. A stack
    of maps (map_loader.stack_maps) carries a leading map axis on every
    field; ``map_at(m)`` is its member m."""

    tile_kind: np.ndarray       # int32 [H, W]
    tile_angle: np.ndarray      # int32 [H, W], 0..3
    drivable: np.ndarray        # bool  [H, W]
    tile_tex: np.ndarray        # int32 [H, W]
    curves: np.ndarray          # f32 [H, W, C, 4, 3]
    curve_mask: np.ndarray      # bool [H, W, C]
    obj_pos: np.ndarray         # f32 [M, 3]
    obj_y_rot: np.ndarray       # f32 [M]
    obj_scale: np.ndarray       # f32 [M]
    obj_kind: np.ndarray        # int32 [M]
    obj_corners: np.ndarray     # f32 [M, 4, 2]
    obj_norms: np.ndarray       # f32 [M, 2, 2]
    obj_safety_rad: np.ndarray  # f32 [M]
    obj_height: np.ndarray      # f32 [M]
    obj_halfdims: np.ndarray    # f32 [M, 2]
    obj_mask: np.ndarray        # bool [M]
    obj_optional: np.ndarray    # bool [M]
    obj_is_dynamic: np.ndarray  # bool [M]
    obj_walk_dist: np.ndarray   # f32 [M]
    tile_size: np.ndarray       # f32 scalar
    drivable_frac: np.ndarray   # f32 [H*W]
    spawn_pos: np.ndarray       # f32 [K, 3]
    spawn_angle: np.ndarray     # f32 [K]
    spawn_lane_deg: np.ndarray  # f32 [K]
    spawn_mask: np.ndarray      # bool [K]
    # the numpy map a tensor copy was made from (None on the numpy map):
    # static decisions read it on the host, never the device tensors
    host: "MapArrays | None" = dataclasses.field(default=None, repr=False)

    def numpy(self) -> "MapArrays":
        """The numpy (host) copy of this map."""
        return self if self.host is None else self.host

    @property
    def is_stack(self) -> bool:
        return self.tile_kind.ndim == 3

    @property
    def n_maps(self) -> int:
        return int(self.tile_kind.shape[0]) if self.is_stack else 1

    def map_at(self, m: int) -> "MapArrays":
        """Member m of a stack: one map on the stack's padded grid and
        object budget (dtown.env.select_map with a constant index)."""
        if not self.is_stack:
            raise ValueError("map_at takes a stack of maps")
        host = None if self.host is None else self.host.map_at(m)
        return MapArrays(host=host, **{f: getattr(self, f)[m]
                                       for f in MAP_FIELDS})

    @property
    def grid_shape(self):
        return self.tile_kind.shape[-2], self.tile_kind.shape[-1]

    @property
    def max_curves(self):
        return self.curves.shape[-3]

    @property
    def max_objects(self):
        return self.obj_pos.shape[-2]

    def to(self, device) -> "MapArrays":
        """Copy of the map with every field as a tensor on ``device``."""
        host = self.numpy()
        return MapArrays(host=host, **{
            f: torch.tensor(np.asarray(getattr(host, f)), device=device)
            for f in MAP_FIELDS
        })


# --- Batched env state ------------------------------------------------------
# Counterparts of dtown.types.DynObjState / LanePosition / EnvState /
# StepOutput. The reference's states are per-env pytrees that jax.vmap
# batches; here every field carries the batch as its leading dimension B.


def _tensor_fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def tree_where(cond, a, b):
    """Field-wise ``where(cond[B], a, b)`` over two states of one type
    (nested dataclasses included; a field that is None stays None)."""
    out = {}
    for name, x in _tensor_fields(a).items():
        y = getattr(b, name)
        if x is None:
            out[name] = None
        elif dataclasses.is_dataclass(x):
            out[name] = tree_where(cond, x, y)
        else:
            out[name] = torch.where(
                cond.reshape(cond.shape + (1,) * (x.dim() - 1)), x, y)
    return type(a)(**out)


@dataclasses.dataclass(frozen=True)
class DynObjState:
    """Dynamic-object state of every env, [B, M] over the object slots."""

    pos: torch.Tensor        # f32 [B, M, 3]
    angle: torch.Tensor      # f32 [B, M]
    vel: torch.Tensor        # f32 [B, M]
    walk_dist: torch.Tensor  # f32 [B, M]
    wiggle: torch.Tensor     # f32 [B, M]
    phase: torch.Tensor      # int32 [B, M] traffic-light phase
    time: torch.Tensor       # f32 [B, M]

    def replace(self, **kw) -> "DynObjState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LanePosition:
    """Lane-relative pose of every env (each [B])."""

    dist: torch.Tensor
    dot_dir: torch.Tensor
    angle_deg: torch.Tensor
    angle_rad: torch.Tensor
    in_lane: torch.Tensor    # bool


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Env state of a batch of B envs. The reference's ``rng`` key has no
    counterpart: the port draws from a torch.Generator passed explicitly."""

    pos: torch.Tensor            # f32 [B, 3]
    angle: torch.Tensor          # f32 [B]
    step_count: torch.Tensor     # int32 [B]
    speed: torch.Tensor          # f32 [B]
    wheel_vels: torch.Tensor     # f32 [B, 2]
    last_action: torch.Tensor    # f32 [B, 2]
    map_idx: torch.Tensor        # int32 [B]
    robot_speed: torch.Tensor    # f32 [B]
    cam_fov_y: torch.Tensor      # f32 [B] degrees
    cam_height: torch.Tensor     # f32 [B]
    cam_angle: torch.Tensor      # f32 [B] degrees
    cam_fwd_dist: torch.Tensor   # f32 [B]
    wheel_dist: torch.Tensor     # f32 [B]
    light_dir: torch.Tensor      # f32 [B, 3]
    light_ambient: torch.Tensor  # f32 [B]
    ground_color: torch.Tensor   # f32 [B, 3]
    horizon_color: torch.Tensor  # f32 [B, 3]
    tex_seed: torch.Tensor       # int32 [B]
    tex_variant: torch.Tensor    # int32 [B, H, W]
    obj_visible: torch.Tensor    # bool [B, M]
    dyn: DynObjState

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    @property
    def batch_size(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> "EnvState":
        """Copy of the state on ``device``."""
        f = {k: v.to(device) for k, v in _tensor_fields(self).items()
             if k != "dyn"}
        dyn = DynObjState(**{k: v.to(device)
                             for k, v in _tensor_fields(self.dyn).items()})
        return EnvState(dyn=dyn, **f)


@dataclasses.dataclass(frozen=True)
class StepOutput:
    """Per-env step outputs (each [B]); ``obs`` is the batched observation
    (uint8 [B, H, W, C] frames, or f32 [B, 11] state vectors)."""

    obs: object
    reward: torch.Tensor
    done: torch.Tensor
    lane_dist: torch.Tensor
    lane_dot_dir: torch.Tensor
    lane_angle_deg: torch.Tensor
    in_lane: torch.Tensor
    collision: torch.Tensor
    timestamp: torch.Tensor

    def replace(self, **kw) -> "StepOutput":
        return dataclasses.replace(self, **kw)
