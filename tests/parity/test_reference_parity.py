"""Exact fixed-seed parity vs the reference environments.

The fixtures under ``tests/parity/fixtures/*.npz`` are recorded from the
actual reference code (``tools/record_reference.py`` replays
``/root/reference/environment/dummy_env_*.py`` under ``np.random.seed(s);
random.seed(s)`` with a deterministic legal-action policy). Two layers of
parity are asserted, per BASELINE.md's correctness criterion:

  1. ``env/compat.py`` reproduces the reference's exact RNG streams: the
     NumPy-faithful generator, seeded identically, must emit byte-identical
     instances (components, pins, nets, cells, ids).
  2. The JAX stepper (`env/core.py`), given the recorded instance, must
     reproduce every recorded step: grid, legal-action mask, placement mask,
     reward, done, and terminal wirelength/intersection info.
"""

import pathlib
import random

import jax
import numpy as np
import pytest

from placement_tpu.env import compat, core, testing
from placement_tpu.env.types import EnvParams, Variant

# slow tier: x64 recorded-trajectory replay (8 configs x 25 trajectories)
pytestmark = pytest.mark.slow

FIX = pathlib.Path(__file__).parent / "fixtures"
N_SEEDS = 25

# Constructor arguments mirrored from tools/record_reference.py.
_PIN_KW = dict(height=10, width=10, net_distribution=2, pin_spread=2,
               min_component_w=2, max_component_w=3,
               min_component_h=1, max_component_h=3,
               max_num_components=6, min_num_components=3,
               min_num_nets=2, max_num_nets=4,
               max_num_pins_per_net=5, min_num_pins_per_net=2,
               reward_beam_width=2,
               weight_wirelength=0.5, weight_num_intersections=0.5)

PARAMS = {
    "square": EnvParams(variant=Variant.SQUARE, height=10, width=10,
                        component_n=2),
    "rect": EnvParams(variant=Variant.RECT, height=10, width=10,
                      min_component_w=1, max_component_w=4,
                      min_component_h=1, max_component_h=4,
                      min_num_components=3, max_num_components=8),
    "pin": EnvParams(variant=Variant.PIN, reward_type="both", **_PIN_KW),
    "pin_centroid": EnvParams(variant=Variant.PIN, reward_type="centroid",
                              **_PIN_KW),
    "pin_spatial": EnvParams(variant=Variant.PIN_SPATIAL, reward_type="both",
                             **_PIN_KW),
    # pure-beam branch of find_reward (dummy_env_rectangular_pin.py:951-975)
    # as its own recorded config (VERDICT r3 item 5)
    "pin_beam": EnvParams(variant=Variant.PIN, reward_type="beam", **_PIN_KW),
    # non-square grid: every (x, y)/(h, w) axis convention under h != w
    "pin_nonsquare": EnvParams(variant=Variant.PIN, reward_type="both",
                               **{**_PIN_KW, "height": 8, "width": 12}),
    # rotation-heavy 1xk components: orientation changes the footprint
    # maximally; degenerate-row pin rotation (place_component:156-204)
    "pin_rot": EnvParams(variant=Variant.PIN, reward_type="both",
                         **{**_PIN_KW, "min_component_h": 1,
                            "max_component_h": 1, "min_component_w": 2,
                            "max_component_w": 4}),
}


@pytest.fixture(scope="module")
def fixtures():
    return {name: np.load(FIX / f"{name}.npz") for name in PARAMS}


def _get(data, seed, key):
    return data[f"s{seed}/{key}"]


def _has(data, seed, key):
    return f"s{seed}/{key}" in data


# ---------------------------------------------------------------------------
# 1. Compat generator: exact RNG-stream reproduction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rect", "pin", "pin_spatial",
                                  "pin_nonsquare", "pin_rot"])
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_compat_generator_streams(fixtures, name, seed):
    data = fixtures[name]
    params = PARAMS[name]
    np.random.seed(seed)
    random.seed(seed)
    inst = compat.generate_instance(params)

    np.testing.assert_array_equal(inst.comp_h, _get(data, seed, "comp_h"))
    np.testing.assert_array_equal(inst.comp_w, _get(data, seed, "comp_w"))
    if params.has_pins:
        assert inst.num_nets == int(_get(data, seed, "num_nets"))
        for field, key in [("rel_x", "pin_rel_x"), ("rel_y", "pin_rel_y"),
                           ("pin_id", "pin_id"), ("comp_id", "pin_comp"),
                           ("net_id", "pin_net")]:
            got = np.array([getattr(q, field) for q in inst.pins], np.int32)
            np.testing.assert_array_equal(got, _get(data, seed, key),
                                          err_msg=f"{name} seed {seed} {key}")


# ---------------------------------------------------------------------------
# 2. Trajectory parity: step-level grid / mask / reward / done equality
# ---------------------------------------------------------------------------

def _inject(params: EnvParams, data, seed):
    """Build the initial EnvState carrying the recorded instance."""
    import jax
    state = core.reset(params, jax.random.PRNGKey(0))
    if params.variant == Variant.SQUARE:
        return state

    comp_h = _get(data, seed, "comp_h")
    comp_w = _get(data, seed, "comp_w")
    comps = [testing.ComponentSpec(int(h), int(w), i)
             for i, (h, w) in enumerate(zip(comp_h, comp_w))]
    if params.has_pins:
        for rx, ry, pid, cid, nid in zip(
                _get(data, seed, "pin_rel_x"), _get(data, seed, "pin_rel_y"),
                _get(data, seed, "pin_id"), _get(data, seed, "pin_comp"),
                _get(data, seed, "pin_net")):
            comps[int(cid)].pins.append(testing.PinSpec(
                int(rx), int(ry), int(pid), int(cid), int(nid)))
    state = testing.set_components(params, state, comps)
    if params.has_pins:
        state = state.replace(
            num_nets=np.int32(int(_get(data, seed, "num_nets"))))
    return state


def _mask_to_ref(params: EnvParams, mask):
    """Our bool[O,H,W] mask in the reference's recorded layout."""
    m = np.asarray(mask).astype(np.int8)
    if params.variant == Variant.SQUARE:
        return m[0]
    if params.variant == Variant.RECT:
        return m
    # pin envs: planes 2,3 are copies of 0,1 (:1866-1869) — ours stores all 4
    return m


# obs entries with genuinely fractional values (area_ratio = area/total);
# everything else is integer-valued and compared exactly
_FLOAT_OBS = ("all_components_feature",)


def _assert_obs_parity(params, data, seed, tag, state, name):
    """Our observe() vs the reference's recorded per-step obs dict
    (_get_obs emissions, dummy_env_rectangular_pin.py:1679-1686,
    ..._pin_spatial.py:1622-1631)."""
    obs = core.observe(params, state)
    compared = 0
    for key, got in obs.items():
        rk = f"{key}@{tag}"
        if not _has(data, seed, rk):
            continue
        want = _get(data, seed, rk)
        got = np.asarray(got)
        msg = f"{name} seed {seed} {key}@{tag}"
        if key == "component_grid":
            # The reference's draw_components sizes the leading dim by the
            # episode's ACTUAL component count (len(self.components),
            # dummy_env_rectangular_pin_spatial.py:1679-1686), contradicting
            # its own declared observation space (max_num_components, :500).
            # Our fixed-shape build pads to max; valid rows must match
            # exactly and padded rows must be all-zero.
            n = want.shape[0]
            assert got.shape[1:] == want.shape[1:], msg
            assert got.shape[0] >= n, msg
            np.testing.assert_array_equal(got[:n].astype(want.dtype), want,
                                          err_msg=msg)
            assert not got[n:].any(), msg + " (nonzero padding rows)"
            compared += 1
            continue
        assert got.shape == want.shape, (
            f"{name} seed {seed} {key}@{tag}: shape {got.shape} "
            f"vs reference {want.shape}")
        if key in _FLOAT_OBS:
            np.testing.assert_allclose(got.astype(np.float64), want,
                                       rtol=1e-6, atol=1e-6, err_msg=msg)
        else:
            np.testing.assert_array_equal(got.astype(want.dtype), want,
                                          err_msg=msg)
        compared += 1
    if params.variant != Variant.SQUARE:
        assert compared >= 3, f"{name} seed {seed} @{tag}: obs keys missing"


def test_fixtures_contain_observations(fixtures):
    """Guard against silently skipping obs parity: every non-square fixture
    must carry recorded per-step observation arrays."""
    for name in ("rect", "pin", "pin_centroid", "pin_spatial", "pin_beam",
                 "pin_nonsquare", "pin_rot"):
        keys = set(fixtures[name].files)
        assert any("@reset" in k for k in keys), name
        assert any("all_components_feature@0" in k for k in keys), name
    assert any("pin_grid@0" in k for k in fixtures["pin_spatial"].files)
    assert any("component_grid@0" in k
               for k in fixtures["pin_spatial"].files)


@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_trajectory_parity(fixtures, name, seed):
    # x64 makes the routing internals compute in float64, reproducing the
    # reference's f64 rounding exactly — including tie-breaking noise in
    # pin_outlier (np.linalg.norm, dummy_env_rectangular_pin.py:1336-1340).
    with jax.enable_x64(True):
        _run_trajectory(fixtures, name, seed)


def _run_trajectory(fixtures, name, seed):
    data = fixtures[name]
    params = PARAMS[name]
    _, step_j, _ = core.make_jitted(params)

    state = _inject(params, data, seed)
    np.testing.assert_array_equal(
        _mask_to_ref(params, state.action_mask),
        _get(data, seed, "mask_reset"),
        err_msg=f"{name} seed {seed} reset mask")
    _assert_obs_parity(params, data, seed, "reset", state, name)

    actions = _get(data, seed, "actions")
    rewards = _get(data, seed, "rewards")
    dones = _get(data, seed, "dones")
    for t in range(actions.shape[0]):
        a = actions[t]
        if params.variant == Variant.SQUARE:
            a3 = np.array([0, a[0], a[1]], np.int32)
        else:
            a3 = a.astype(np.int32)
        state, reward, done, info = step_j(state, a3)

        np.testing.assert_array_equal(
            np.asarray(state.grid, np.int8), _get(data, seed, f"grid{t}"),
            err_msg=f"{name} seed {seed} grid@{t}")
        np.testing.assert_array_equal(
            _mask_to_ref(params, state.action_mask),
            _get(data, seed, f"mask{t}"),
            err_msg=f"{name} seed {seed} mask@{t}")
        assert bool(done) == bool(dones[t]), f"{name} seed {seed} done@{t}"
        assert np.isclose(float(reward), rewards[t], rtol=1e-5, atol=1e-5), \
            f"{name} seed {seed} reward@{t}: {float(reward)} vs {rewards[t]}"
        if _has(data, seed, f"pmask{t}"):
            got = np.asarray(core.placement_mask(params, state), np.float32)
            np.testing.assert_array_equal(
                got, _get(data, seed, f"pmask{t}"),
                err_msg=f"{name} seed {seed} placement_mask@{t}")
        _assert_obs_parity(params, data, seed, t, state, name)

    if _has(data, seed, "wirelength"):
        assert np.isclose(float(state.info_wirelength),
                          _get(data, seed, "wirelength"),
                          rtol=1e-5, atol=1e-5), f"{name} seed {seed} wl"
        assert np.isclose(float(state.info_intersections),
                          _get(data, seed, "intersections"),
                          rtol=1e-5, atol=1e-5), f"{name} seed {seed} ints"


# ---------------------------------------------------------------------------
# 3. Production-dtype (f32) terminal-reward deviation bound
# ---------------------------------------------------------------------------

# Measured worst-case f32-vs-f64 terminal deviations over the recorded
# fixtures (25 seeds per config): the centroid reward path is rounding-tight;
# beam/"both" paths deviate on isolated seeds for two reasons: (a) near-tie
# beam routes that f64 orders differently than f32 cost sums, and (b) the
# production path's exact-integer crossing predicate counting a touching
# intersection the reference's f64 division rounds just outside its box
# check (see routing._pairwise_intersect_ref_float — the x64 parity path
# reproduces the reference's rounding; f32 production keeps the exact
# predicate). Measured: 1 deviating seed on pin/pin_spatial/pin_beam, 4 on
# pin_nonsquare, 0 on pin_rot; worst |reward| shift 0.096.
_F32_TIGHT = 1e-5
_F32_TIE_ABS = 0.15          # measured worst 0.096 + headroom
_F32_MAX_TIE_SEEDS = 5       # measured worst 4 of 25 (pin_nonsquare)


@pytest.mark.parametrize("name", ["pin", "pin_centroid", "pin_spatial",
                                  "pin_beam", "pin_nonsquare", "pin_rot"])
def test_production_f32_terminal_reward_deviation(fixtures, name):
    """Quantify the production pure-JAX path's float32 terminal rewards
    against the reference's float64 values on the recorded trajectories
    (the x64 trajectory-parity test above proves exactness under f64; this
    one states the bound users actually run under). Centroid routing is
    rounding-tight; beam/'both' may flip near-tie routes on isolated seeds
    (heapq order on f64-equal costs is not defined by f32 arithmetic),
    bounded below."""
    data = fixtures[name]
    params = PARAMS[name]
    assert not jax.config.jax_enable_x64
    _, step_j, _ = core.make_jitted(params)
    tie_seeds = []
    for seed in range(N_SEEDS):
        state = _inject(params, data, seed)
        actions = _get(data, seed, "actions")
        rewards = _get(data, seed, "rewards")
        reward = None
        for t in range(actions.shape[0]):
            state, reward, done, _ = step_j(state, actions[t].astype(np.int32))
        dev = abs(float(reward) - float(rewards[-1]))
        if dev <= _F32_TIGHT:
            # reward tight => same route chosen => integer crossing count
            # must agree exactly
            if _has(data, seed, "intersections"):
                assert np.isclose(float(state.info_intersections),
                                  float(_get(data, seed, "intersections")),
                                  atol=1e-6), f"{name} seed {seed} ints"
            continue
        assert params.reward_type != "centroid", (
            f"{name} seed {seed}: centroid path must be rounding-tight, "
            f"deviated {dev:.3e}")
        assert dev <= _F32_TIE_ABS, (
            f"{name} seed {seed}: f32 route-tie deviation {dev:.3e} exceeds "
            f"the measured envelope {_F32_TIE_ABS}")
        tie_seeds.append(seed)
    assert len(tie_seeds) <= _F32_MAX_TIE_SEEDS, (
        f"{name}: {len(tie_seeds)} seeds flipped routes under f32 "
        f"({tie_seeds}) — more than the measured envelope")
