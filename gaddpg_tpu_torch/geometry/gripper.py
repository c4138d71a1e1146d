"""Panda gripper anchor points (counterpart of gaddpg_tpu/geometry/gripper.py).

Only the hand anchor points of the point state are needed by the serving
path; the control points and point-matching transforms come with the
losses.
"""

import numpy as np

# 6 anchor points on the hand in the wrist-camera-aligned frame used by
# the point-cloud state: columns are points (3, 6)
# (reference: core/utils.py:38-40).
HAND_FINGER_POINTS = np.array(
    [
        [0.0, 0.0, 0.0, -0.0, 0.0, -0.0],
        [0.0, 0.0, 0.053, -0.053, 0.053, -0.053],
        [0.0, 0.0, 0.075, 0.075, 0.105, 0.105],
    ],
    dtype=np.float32,
)
