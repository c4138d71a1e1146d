"""Point-cloud and physics ops: plain PyTorch versions and the CUDA kernels
behind them.

Every kernel wrapper here dispatches on the device of its input: a CPU
tensor runs the plain PyTorch version, a CUDA tensor launches the
hand-written kernel (built by `ops.build` at first use) or raises. There
is no switch, probe or fallback between the two.
"""

from gaddpg_tpu_torch.ops.sampling import (  # noqa: E402
    ball_query, furthest_point_sampling, gather_points, group_points, regularize_point_count,
)

__all__ = ["ball_query", "furthest_point_sampling", "gather_points", "group_points",
           "regularize_point_count"]
