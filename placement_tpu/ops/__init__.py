"""Hot array ops for the placement engine."""

from placement_tpu.ops.sat import (  # noqa: F401
    free_placement_mask,
    orientation_action_mask,
    paint_rectangle,
)
