"""Physical and simulation constants (PyTorch port).

Same values as dtown/constants.py, plus the NPC constants of
dtown/objects.py and the nominal lighting of dtown/randomization.py that
the map compiler and the render plan need.

Coordinate convention: y-up, ground is the x-z plane, heading ``angle`` is
about +y with dir_vec = (cos, 0, -sin) and right_vec = (sin, 0, cos).
"""
import numpy as np

# --- Camera ------------------------------------------------------------
DEFAULT_CAMERA_WIDTH = 640
DEFAULT_CAMERA_HEIGHT = 480
CAMERA_FOV_Y = 42.0          # degrees, vertical FOV
CAMERA_FLOOR_DIST = 0.108    # m, camera height above ground
CAMERA_FORWARD_DIST = 0.066  # m, camera forward offset from axle center
CAMERA_ANGLE = 19.15         # degrees, downward pitch
CAMERA_NEAR = 0.04
CAMERA_FAR = 100.0

# --- Robot body --------------------------------------------------------
WHEEL_DIST = 0.102
ROBOT_WIDTH = 0.13 + 0.02
ROBOT_LENGTH = 0.18
ROBOT_HEIGHT = 0.12
SAFETY_RAD_MULT = 1.8
AGENT_SAFETY_RAD = (max(ROBOT_LENGTH, ROBOT_WIDTH) / 2.0) * SAFETY_RAD_MULT
MIN_SPAWN_OBJ_DIST = 0.25

# --- Dynamics ----------------------------------------------------------
DEFAULT_ROBOT_SPEED = 1.20
DEFAULT_FRAMERATE = 30
DEFAULT_FRAME_SKIP = 1
DEFAULT_MAX_STEPS = 1500
DEFAULT_ACCEPT_START_ANGLE_DEG = 60.0
MAX_SPAWN_ATTEMPTS = 5000

# --- Wheel-model inverse kinematics -------------------------------------
DEFAULT_GAIN = 1.0
DEFAULT_TRIM = 0.0
DEFAULT_WHEEL_RADIUS = 0.0318
DEFAULT_K = 27.0
DEFAULT_LIMIT = 1.0

# --- Reward ------------------------------------------------------------
REWARD_INVALID_POSE = -1000.0
REWARD_SPEED_COEF = 1.0
REWARD_DIST_COEF = -10.0
REWARD_COLLISION_COEF = 40.0
NAV_GOAL_REWARD = 500.0

# --- Map ---------------------------------------------------------------
DEFAULT_TILE_SIZE = 0.585
DEFAULT_MAP_NAME = "udem1"

# --- Bezier lane geometry ----------------------------------------------
BEZIER_CLOSEST_ITERS = 8
LANE_OFFSET = 0.20

# --- Moving NPCs (dtown/objects.py) -------------------------------------
DUCKIE_WALK_SPEED = 0.02
DUCKIE_WALK_DISTANCE = 0.25
DUCKIE_WIGGLE = 0.25
DUCKIE_WIGGLE_FREQ = 48.0
TRAFFICLIGHT_PERIOD = 5.0
DUCKIEBOT_VEL = 0.4
DUCKIEBOT_GAIN = 0.15
DUCKIEBOT_FOLLOW_DIST = 0.30

# --- Nominal lighting (dtown/randomization.py); f32 on purpose: the render
# plan reads these exact float32 values ------------------------------------
NOMINAL_GROUND_COLOR = np.array([0.15, 0.15, 0.15], dtype=np.float32)
NOMINAL_HORIZON_COLOR = np.array([0.45, 0.62, 0.93], dtype=np.float32)
NOMINAL_LIGHT_DIR = np.array([-0.35, -0.82, -0.45], dtype=np.float32)
NOMINAL_AMBIENT = 0.55
