"""Routing-geometry parity: golden values ported from the reference
tests/pin_environment/test_env.py (is_intersect, crossing counts, centroid
and beam routes, wirelength, upper bounds)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from placement_tpu.env import EnvParams, Variant
from placement_tpu.env import routing


def seg(a, b):
    return [a[0], a[1], b[0], b[1]]


@functools.lru_cache()
def _intersect_fn():
    return jax.jit(routing._pairwise_intersect)


def intersects(l1, l2):
    f = _intersect_fn()
    return bool(f(jnp.asarray(seg(*l1), jnp.float32),
                  jnp.asarray(seg(*l2), jnp.float32)))


def test_intersection_0():
    # reference test_env.py:40-44
    assert not intersects(((1, 1), (3, 3)), ((1, 3), (1, 5)))


def test_intersection_1():
    # reference test_env.py:47-51
    assert intersects(((1, 1), (3, 3)), ((1, 3), (2, 1)))


def test_shared_endpoint_counts():
    # is_intersect:711-717 — shared endpoints always intersect
    assert intersects(((0, 0), (1, 1)), ((1, 1), (2, 0)))
    # parallel non-touching -> no
    assert not intersects(((0, 0), (1, 1)), ((0, 1), (1, 2)))


@functools.lru_cache()
def _count_fn():
    return jax.jit(routing.count_crossings)


def crossings(nets):
    """nets: list of lists of ((x1,y1),(x2,y2)) segments."""
    n = len(nets)
    m = max(len(net) for net in nets)
    segs = np.zeros((n, m, 4), np.float32)
    valid = np.zeros((n, m), bool)
    for i, net in enumerate(nets):
        for j, (a, b) in enumerate(net):
            segs[i, j] = seg(a, b)
            valid[i, j] = True
    return int(_count_fn()(jnp.asarray(segs), jnp.asarray(valid)))


def test_find_num_intersection():
    # reference test_env.py:54-68 — expected 4
    assert crossings([
        [((1, 1), (3, 3))],
        [((2, 1), (0, 3))],
        [((2, 3), (0, 1))],
        [((3, 2), (1, 3))],
    ]) == 4


def test_lowest_num_intersections():
    # reference test_env.py:71-86 — routes have 4 and 1 crossings
    a = crossings([
        [((1, 1), (3, 3))],
        [((2, 1), (0, 3))],
        [((2, 3), (0, 1))],
        [((3, 2), (1, 3))]])
    b = crossings([[((4, 4), (3, 5))], [((3, 4), (4, 5))]])
    assert (min(a, b), [a, b].index(min(a, b))) == (1, 1)


def test_upper_bound_intersections():
    # reference test_env.py:89-94: 6x6 grid, nets 2..3, ppn<=4 -> 48
    p = EnvParams(variant=Variant.PIN, height=6, width=6,
                  min_component_w=2, max_component_w=4,
                  min_component_h=2, max_component_h=4,
                  max_num_components=4, min_num_components=1,
                  min_num_nets=2, max_num_nets=3, max_num_pins_per_net=4)
    assert p.max_num_intersections == 48


def test_upper_bound_wirelength():
    # reference test_env.py:185-192: 6x6, nets=4, ppn=2 -> 0.5*8*sqrt(72)
    p = EnvParams(variant=Variant.PIN, height=6, width=6,
                  min_component_w=2, max_component_w=4,
                  min_component_h=2, max_component_h=4,
                  max_num_components=4, min_num_components=2,
                  min_num_nets=4, max_num_nets=4, max_num_pins_per_net=2)
    assert np.isclose(p.max_wirelength, 0.5 * 8 * math.sqrt(72))


def _table(params, pins):
    """pins: list of (x, y, net)."""
    p = params.max_pins
    ax = np.full(p, -1, np.int32)
    ay = np.full(p, -1, np.int32)
    nets = np.full(p, -1, np.int32)
    for i, (x, y, n) in enumerate(pins):
        ax[i], ay[i], nets[i] = x, y, n
    return routing.net_pin_table(params, jnp.asarray(ax), jnp.asarray(ay),
                                 jnp.asarray(nets))


PARAMS_10 = EnvParams(variant=Variant.PIN, height=10, width=10,
                      min_component_w=2, max_component_w=4,
                      min_component_h=2, max_component_h=4,
                      max_num_components=4, min_num_components=2,
                      min_num_nets=2, max_num_nets=2,
                      min_num_pins_per_net=2, max_num_pins_per_net=5)


def segset(segs, valid):
    out = set()
    s = np.asarray(segs)
    v = np.asarray(valid)
    for i in range(s.shape[0]):
        for j in range(s.shape[1]):
            if v[i, j]:
                out.add(tuple(np.round(s[i, j], 5)))
    return out


def test_route_pins_centroid():
    # reference test_env.py:104-123
    pos, mask, _ = _table(PARAMS_10,
                          [(0, 0, 0), (0, 1, 0),
                           (2, 2, 1), (3, 3, 1), (4, 4, 1)])
    segs, valid, seg_scaled, scale = jax.jit(routing.centroid_route)(pos, mask)
    assert segset(segs, valid) == {
        (0, 0, 0, 1),
        (2, 2, 3.0, 3.0), (3, 3, 3.0, 3.0), (4, 4, 3.0, 3.0)}
    # scaled form: pin*count with raw coordinate sums for the centroid
    assert segset(seg_scaled, valid) == {
        (0, 0, 0, 1),
        (6, 6, 9.0, 9.0), (9, 9, 9.0, 9.0), (12, 12, 9.0, 9.0)}
    assert np.asarray(scale)[:2].tolist() == [1.0, 3.0]


def test_pin_outlier():
    # reference test_env.py:126-133
    pts = [(0, 0, 0), (0, 1, 0), (1, 0, 0), (3, 3, 0)]
    pos, mask, _ = _table(PARAMS_10, pts)
    idx = int(jax.jit(routing.pin_outlier_index)(pos[0], mask[0]))
    assert tuple(np.asarray(pos[0][idx])) == (3, 3)


def beam_path(points, bw, start_idx=0):
    m = len(points)
    pos = jnp.asarray(np.array(points, np.float32))
    mask = jnp.ones((m,), bool)
    table = routing.sqrt_table(2 * 10 ** 2, jnp.float32)
    fn = jax.jit(lambda p, ms: routing.beam_search_net(p, ms, bw, start_idx,
                                                       table))
    path = np.asarray(fn(pos, mask))
    return [tuple(points[i]) for i in path if i >= 0]


def test_beam_search_width_full():
    # reference test_env.py:136-144
    pts = [(0, 0), (2, 2), (0, 1), (1, 0), (1, 1)]
    assert beam_path(pts, 4) == [(0, 0), (0, 1), (1, 0), (1, 1), (2, 2)]


def test_beam_search_width_2():
    # reference test_env.py:147-155 — exercises the heapq lexicographic
    # tie-break on equal path costs
    pts = [(0, 0), (2, 2), (0, 1), (1, 0), (1, 1)]
    assert beam_path(pts, 2) == [(0, 0), (0, 1), (1, 1), (1, 0), (2, 2)]


def test_beam_search_route_pins():
    # reference test_env.py:158-178
    pins = [(3, 3, 0), (3, 4, 0),
            (0, 0, 1), (0, 1, 1), (1, 0, 1), (1, 1, 1), (2, 2, 1)]
    pos, mask, _ = _table(PARAMS_10, pins)
    segs, valid = jax.jit(
        lambda p, ms: routing.beam_route(PARAMS_10, p, ms, 2))(pos, mask)
    assert segset(segs, valid) == {
        (3, 3, 3, 4),
        (2, 2, 1, 1), (1, 1, 0, 1), (0, 1, 0, 0), (0, 0, 1, 0)}


def test_find_wirelength():
    # reference test_env.py:181-183
    segs = jnp.asarray([[seg((3, 1), (2, 2)), seg((1, 2), (2, 2)),
                         seg((3, 3), (2, 2))]], jnp.float32)
    valid = jnp.ones((1, 3), bool)
    wl = float(jax.jit(routing.wirelength)(segs, valid))
    assert np.isclose(wl, 1 + 2 * np.sqrt(2), rtol=1e-5)
