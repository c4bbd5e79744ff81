"""Environment parameter and state containers.

The reference implements four mutable-object gym environments
(``environment/dummy_env_square.py:10``, ``dummy_env_rectangular.py:98``,
``dummy_env_rectangular_pin.py:298``, ``dummy_env_rectangular_pin_spatial.py:290``).
Here all four variants are configurations of one fixed-shape, pure-functional
state pytree so the stepper can be ``vmap``-ed over thousands of boards and
compiled once per ``EnvParams``.

Every variable-length Python list in the reference (components, pins, nets)
becomes a padded array plus a validity predicate derived from scalar counts.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any

import jax.numpy as jnp

from placement_tpu.utils import pytree


class Variant(enum.IntEnum):
    """Which of the four reference environments to emulate."""

    SQUARE = 0        # dummy_env_square.py
    RECT = 1          # dummy_env_rectangular.py
    PIN = 2           # dummy_env_rectangular_pin.py
    PIN_SPATIAL = 3   # dummy_env_rectangular_pin_spatial.py


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static environment configuration (hashable; jit-specialized).

    Field names mirror the reference constructor signatures
    (``dummy_env_rectangular_pin.py:396-416``) so the ``agent/config/*.json``
    schema loads directly.
    """

    variant: Variant = Variant.PIN
    height: int = 10
    width: int = 10

    # Square variant only (dummy_env_square.py:37).
    component_n: int = 2

    # Component geometry (rect + pin variants).
    min_component_w: int = 2
    max_component_w: int = 2
    min_component_h: int = 2
    max_component_h: int = 2
    min_num_components: int = 5
    max_num_components: int = 5

    # Nets / pins (pin variants), cf. dummy_env_rectangular_pin.py:400-411.
    net_distribution: int = 9
    pin_spread: int = 9
    min_num_nets: int = 3
    max_num_nets: int = 3
    min_num_pins_per_net: int = 2
    max_num_pins_per_net: int = 6

    # Sampling fidelity: False = vectorized capped multinomials (one round +
    # deterministic water-fill; equals the reference whenever no cap binds —
    # the throughput path). True = sequential per-trial/per-round samplers
    # reproducing the reference's exact sampling PROCESS in cap-bound
    # regimes (sample_truncated_multinomial:258-295,
    # allocate_pins_to_components_for_net:1176-1264) at ~max_trials extra
    # kernels per reset.
    exact_sampling: bool = False

    # Reward (pin variants), cf. dummy_env_rectangular_pin.py:412-416.
    reward_type: str = "both"  # "beam" | "centroid" | "both"
    reward_beam_width: int = 2
    weight_wirelength: float = 0.5
    weight_num_intersections: float = 0.5

    # ---- derived static sizes -------------------------------------------------

    @property
    def area(self) -> int:
        return self.height * self.width

    @property
    def num_orientations(self) -> int:
        return {Variant.SQUARE: 1, Variant.RECT: 2,
                Variant.PIN: 4, Variant.PIN_SPATIAL: 4}[self.variant]

    @property
    def max_components(self) -> int:
        """Padded component-table length (1 for the square variant)."""
        if self.variant == Variant.SQUARE:
            return 1
        return self.max_num_components

    @property
    def max_num_pins_per_component(self) -> int:
        # dummy_env_rectangular_pin.py:481
        return self.max_component_h * self.max_component_w

    @property
    def max_pins(self) -> int:
        """Padded global pin-table length."""
        if self.variant in (Variant.SQUARE, Variant.RECT):
            return 1
        return self.max_num_nets * self.max_num_pins_per_net

    @property
    def max_segments_per_net(self) -> int:
        """Worst-case routed segments for one net (centroid: one per pin)."""
        return self.max_num_pins_per_net

    @property
    def has_pins(self) -> bool:
        return self.variant in (Variant.PIN, Variant.PIN_SPATIAL)

    # Upper-bound penalty terms, cf. dummy_env_rectangular_pin.py:761-830.
    @property
    def max_wirelength(self) -> float:
        dist = math.hypot(float(self.height), float(self.width))
        total = 0.5 * dist * (self.max_num_nets * self.max_num_pins_per_net)
        if self.variant == Variant.PIN_SPATIAL:
            # Spatial env pre-normalizes by (h + w), dummy_env_rectangular_pin_spatial.py:746.
            return total / (self.height + self.width)
        return total

    @property
    def max_num_intersections(self) -> float:
        v = (0.5 * self.max_num_pins_per_net ** 2
             * self.max_num_nets * (self.max_num_nets - 1))
        if self.variant == Variant.PIN_SPATIAL:
            return v  # spatial env keeps the float, dummy_env_rectangular_pin_spatial.py:785
        return float(int(v))  # pin env truncates to int, dummy_env_rectangular_pin.py:822

    @property
    def intersections_normalizer(self) -> float:
        """min(avg pins by component area, avg pins by nets); find_reward:882-896."""
        avg_by_comp = (0.5 * (self.min_component_h + self.max_component_h)
                       * 0.5 * (self.min_component_w + self.max_component_w)
                       * 0.5 * (self.min_num_components + self.max_num_components))
        avg_by_net = (0.5 * (self.min_num_pins_per_net + self.max_num_pins_per_net)
                      * 0.5 * (self.min_num_nets + self.max_num_nets))
        return min(avg_by_comp, avg_by_net)

    @property
    def wirelength_normalizer(self) -> float:
        return float(self.height + self.width)

    def validate(self) -> "EnvParams":
        """Mirror of the reference's constructor validation
        (dummy_env_rectangular_pin.py:565-641, dummy_env_rectangular.py:239-251,
        dummy_env_square.py:67-72). Returns self for chaining."""
        if self.height <= 0 or self.width <= 0:
            raise ValueError("Grid size must be greater than 0.")
        if self.variant == Variant.SQUARE:
            if self.component_n > self.height or self.component_n > self.width:
                raise ValueError(
                    "Component size must be less than or equal to the grid size.")
            return self
        if (self.max_component_w > self.width
                or self.max_component_h > self.height):
            raise ValueError(
                "Component size must be less than or equal to the grid size.")
        if self.min_component_w < 1 or self.min_component_h < 1:
            raise ValueError("Component size must be greater than 0.")
        if self.max_num_components < 1 or self.max_num_components > self.area:
            raise ValueError(
                "Number of components must be greater than 0 and less than or "
                "equal to the grid area.")
        if not self.has_pins:
            return self
        if self.min_num_pins_per_net > self.max_num_pins_per_net:
            raise ValueError(
                "min_num_pins_per_net must not be greater than max num pins per net")
        if self.min_num_pins_per_net < 2:
            raise ValueError("min num pins per net must be at least 2.")
        if (self.min_num_pins_per_net * self.min_num_nets
                > self.min_component_w * self.min_component_h
                * self.min_num_components):
            raise ValueError(
                "min_num_pins_per_net * min_num_nets must be less than or equal "
                "to the total minimum area covered by the components")
        if self.reward_beam_width < 1:
            raise ValueError("Beam width must be a positive integer.")
        if self.reward_type not in ("beam", "centroid", "both"):
            raise ValueError(
                "Reward type must be either 'beam', 'centroid', or 'both'.")
        return self

    def replace(self, **kw: Any) -> "EnvParams":
        return dataclasses.replace(self, **kw)


@pytree.dataclass
class EnvState:
    """One board's full state as a fixed-shape pytree.

    Shapes (H,W = grid; O = orientations; C = max_components; P = max_pins)
    are all static per ``EnvParams``, so ``vmap(step)`` compiles to one
    batched program.
    """

    # Board occupancy; 1 = occupied (dummy_env_*.py self.grid).
    grid: jnp.ndarray            # i32[H, W]
    # Legal-action planes per orientation (self.action_mask).
    action_mask: jnp.ndarray     # bool[O, H, W]

    # Component table (reference: List[Component]).
    comp_h: jnp.ndarray          # i32[C] original height (never rotated)
    comp_w: jnp.ndarray          # i32[C]
    comp_x: jnp.ndarray          # i32[C] top-left row, -1 when unplaced
    comp_y: jnp.ndarray          # i32[C]
    num_components: jnp.ndarray  # i32[]  components in this instance
    cursor: jnp.ndarray          # i32[]  index of current component (== num_components when all placed)

    # Pin table (reference: List[Pin]; pin variants only — length-1 dummies otherwise).
    pin_rel_x: jnp.ndarray       # i32[P] rotation-updated relative row (Pin.relative_x)
    pin_rel_y: jnp.ndarray       # i32[P]
    pin_abs_x: jnp.ndarray       # i32[P] absolute row; -1 until component placed
    pin_abs_y: jnp.ndarray       # i32[P]
    pin_net: jnp.ndarray         # i32[P] net id (Pin.net_id), -1 for padding
    pin_comp: jnp.ndarray        # i32[P] owning component id, -1 for padding
    pin_local: jnp.ndarray       # i32[P] pin id within component (PIN) or global id (PIN_SPATIAL)
    pin_rel_x0: jnp.ndarray      # i32[P] reset-time relative row (pre-rotation; spatial component_grid)
    pin_rel_y0: jnp.ndarray      # i32[P]
    num_nets: jnp.ndarray        # i32[]
    num_pins: jnp.ndarray        # i32[]

    # Episode bookkeeping.
    done: jnp.ndarray            # bool[]
    steps: jnp.ndarray           # i32[]
    key: jnp.ndarray             # PRNG key for auto-reset regeneration

    # Terminal-reward components surfaced in `info`
    # (dummy_env_rectangular_pin.py:1673-1678, 1705-1709).
    info_wirelength: jnp.ndarray     # f32[]
    info_intersections: jnp.ndarray  # f32[]

    @property
    def comp_valid(self) -> jnp.ndarray:
        c = self.comp_h.shape[0]
        return jnp.arange(c) < self.num_components

    @property
    def comp_placed(self) -> jnp.ndarray:
        c = self.comp_h.shape[0]
        return jnp.arange(c) < self.cursor

    @property
    def pin_valid(self) -> jnp.ndarray:
        return self.pin_net >= 0
