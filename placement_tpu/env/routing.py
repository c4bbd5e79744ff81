"""Routing-based terminal reward as fixed-shape array reductions.

Reference subsystem: dummy_env_rectangular_pin.py:643-975
  * centroid routing        route_pins_centroid:1296
  * beam-search routing     beam_search:1356 / route_pins_beam_search:1425
  * crossing count          find_num_intersection:663 / is_intersect:687
  * wirelength              find_wirelength:741
  * reward composition      find_reward:832

Design: all nets are routed simultaneously on padded
``[N, M]`` pin tensors; the O(nets^2 * segments^2) Python crossing loops
become one vectorized all-pairs predicate over a padded segment table with a
cross-net mask; the heapq beam search becomes a ``lax.scan`` over path length
with a fixed ``[beam]`` frontier and lexicographic tie-breaking that mirrors
heap ordering.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from placement_tpu.env.types import EnvParams

F32 = jnp.float32
# np scalar, not jnp: a module-level jnp constant would initialize the XLA
# backend at import time, breaking jax.distributed.initialize for any CLI
# that imports placement_tpu before calling it. Value-identical (1e9 is
# exactly representable in f32).
BIG = np.float32(1e9)


def _flt():
    """Internal float dtype: float64 when x64 is enabled (the parity suite
    runs under ``jax.experimental.enable_x64`` so distance/centroid rounding
    — including the reference's f64 tie-breaking noise in ``pin_outlier``,
    np.linalg.norm at :1336-1339 — matches NumPy bit-for-bit), float32 in
    production, where accelerators run f64 slowly or not at all."""
    return jax.dtypes.canonicalize_dtype(jnp.float64)


def net_pin_table(params: EnvParams, pin_abs_x, pin_abs_y,
                  pin_net) -> "tuple[jnp.ndarray, jnp.ndarray]":
    """Scatter the flat pin table into per-net position tensors.

    Returns (pos f32[N, M, 2], mask bool[N, M], counts i32[N]). Slot order
    within a net is pin-table order, which is the reference's net-grouped
    ``self.pins`` order (dummy_env_rectangular_pin.py:1167-1169).
    """
    n, m = params.max_num_nets, params.max_num_pins_per_net
    p = pin_net.shape[0]
    valid = pin_net >= 0
    # rank of pin within its net (stable, table order)
    same = (pin_net[None, :] == pin_net[:, None]) & valid[None, :] & valid[:, None]
    rank = jnp.sum(jnp.tril(same, k=-1), axis=1)

    net_idx = jnp.where(valid, pin_net, n)        # overflow row for padding
    rank = jnp.where(valid, jnp.clip(rank, 0, m - 1), m)

    flt = _flt()
    pos = jnp.zeros((n + 1, m + 1, 2), flt)
    pos = pos.at[net_idx, rank, 0].set(pin_abs_x.astype(flt))
    pos = pos.at[net_idx, rank, 1].set(pin_abs_y.astype(flt))
    mask = jnp.zeros((n + 1, m + 1), bool).at[net_idx, rank].set(valid)
    counts = jnp.sum(mask[:n, :m], axis=1)
    return pos[:n, :m], mask[:n, :m], counts


# ---------------------------------------------------------------------------
# Centroid routing (route_pins_centroid:1296-1324)
# ---------------------------------------------------------------------------

def centroid_route(pos, mask) -> tuple:
    """Segments f32[N, M, 4] + validity bool[N, M] + exact scaled form.

    A net with exactly two pins is routed directly pin->pin; otherwise every
    pin connects to the net centroid.

    Returns ``(seg, seg_valid, seg_scaled, scale)``: ``seg`` carries the
    real-valued endpoints (for wirelength); ``seg_scaled[n] = seg[n] *
    scale[n]`` holds EXACT integer coordinates (the centroid sx/c is stored
    as the integer coordinate-sum sx), so the crossing predicate can be
    evaluated in exact arithmetic — see ``count_crossings``.
    """
    counts = jnp.sum(mask, axis=1)
    csum = jnp.sum(jnp.where(mask[..., None], pos, 0.0), axis=1)
    denom = jnp.maximum(counts, 1)[:, None].astype(pos.dtype)
    centroid = csum / denom

    # star segments pin -> centroid
    star = jnp.concatenate(
        [pos, jnp.broadcast_to(centroid[:, None, :], pos.shape)], axis=-1)
    star_scaled = jnp.concatenate(
        [pos * denom[:, :, None],
         jnp.broadcast_to(csum[:, None, :], pos.shape)], axis=-1)
    star_valid = mask

    # two-pin direct segment occupies slot 0 only
    direct = jnp.concatenate([pos[:, 0], pos[:, 1]], axis=-1)  # [N, 4]
    two = (counts == 2)[:, None]
    seg = jnp.where(two[..., None], 0.0, star)
    seg = seg.at[:, 0].set(jnp.where(two, direct, seg[:, 0]))
    seg_scaled = jnp.where(two[..., None], 0.0, star_scaled)
    seg_scaled = seg_scaled.at[:, 0].set(
        jnp.where(two, direct, seg_scaled[:, 0]))
    scale = jnp.where(two[:, 0], 1, jnp.maximum(counts, 1)).astype(pos.dtype)
    seg_valid = jnp.where(two, jnp.arange(mask.shape[1])[None, :] == 0,
                          star_valid)
    seg_valid = seg_valid & (counts > 0)[:, None]
    return seg, seg_valid, seg_scaled, scale


# ---------------------------------------------------------------------------
# Beam-search routing (beam_search:1356-1423)
# ---------------------------------------------------------------------------

_COORD_BASE = np.float32(1 << 15)  # np, not jnp: see BIG above


def _point_key(pos):
    """Scalar order key per point equal to lexicographic (x, y) comparison
    for coordinates < 2^15 (heapq compares the coordinate tuples when path
    priorities tie)."""
    return pos[..., 0] * _COORD_BASE + pos[..., 1]


def _heap_order(cost, path_keys):
    """Indices sorting candidates the way heapq pops (priority, path)
    tuples: primary = cost, then the path's point tuples lexicographically.
    ``path_keys`` f32[K, L] holds the per-position point keys."""
    keys = tuple(path_keys[:, i] for i in range(path_keys.shape[1] - 1, -1, -1))
    return jnp.lexsort(keys + (cost,))


def sqrt_table(max_sq: int, dtype) -> jnp.ndarray:
    """Correctly rounded ``sqrt(k)`` for every integer ``k <= max_sq``.

    Pin coordinates are integers, so every routing distance is the root of
    an integer. Looking it up keeps path costs bit-identical across
    backends: a GPU square root need not be correctly rounded, and a 1-ulp
    difference flips ties such as ``sqrt(8)`` against ``2 * sqrt(2)``
    between two equal-length paths."""
    return jnp.asarray(np.sqrt(np.arange(max_sq + 1, dtype=np.float64)),
                       dtype)


def beam_search_net(pos, mask, beam_width: int, start,
                    roots) -> jnp.ndarray:
    """Shortest pin-visiting path for one net -> path indices i32[M].

    Each round, up to ``beam_width`` frontier paths each expand to their
    ``beam_width`` nearest unvisited pins (stable distance sort => ties by
    pin order, like the reference's ``sorted``), and the ``beam_width`` best
    new paths survive ranked by (total distance, lexicographic coordinate
    path) — exactly the heapq ordering of beam_search:1356-1423.
    ``roots`` (``sqrt_table``) covers every squared pin distance.
    """
    m = pos.shape[0]
    bw = beam_width
    count = jnp.sum(mask)
    pkeys = _point_key(pos)
    # argmax-derived start is i64 under jax.enable_x64 (the parity suite);
    # pin it so the scatters below stay i32-typed
    start = jnp.asarray(start, jnp.int32)

    paths = jnp.full((bw, m), -1, jnp.int32).at[:, 0].set(start)
    # key dtype follows pos (f64 under the x64 parity suite, f32 in prod)
    path_keys = jnp.full((bw, m), -1.0, pkeys.dtype).at[:, 0].set(pkeys[start])
    visited = jnp.zeros((bw, m), bool).at[:, start].set(True)
    visited = visited | ~mask[None, :]
    cost = jnp.where(jnp.arange(bw) == 0, 0.0, BIG).astype(pos.dtype)
    current = jnp.full((bw,), start, jnp.int32)

    def round_(state, step):
        paths, path_keys, visited, cost, current = state
        # distances from each frontier head to every pin
        sq = jnp.sum(jnp.square(pos[None, :, :] - pos[current][:, None, :]),
                     axis=-1)                              # [bw, m], integers
        d = jnp.take(roots, sq.astype(jnp.int32), mode="clip")
        d = jnp.where(visited, BIG, d)
        # stable sort => equal distances break by pin index, like sorted()
        nbr_order = jnp.argsort(d, axis=1, stable=True)    # [bw, m]
        nbr = nbr_order[:, :bw].astype(jnp.int32)          # [bw, bw]
        nbr_d = jnp.take_along_axis(d, nbr, axis=1)

        # candidate paths [bw*bw, m]
        cand_cost = (cost[:, None] + nbr_d).reshape(-1)
        cand_parent = jnp.repeat(jnp.arange(bw), bw)
        cand_pin = nbr.reshape(-1)
        rows = jnp.arange(bw * bw)
        cols = jnp.full((bw * bw,), step + 1)
        cand_paths = paths[cand_parent].at[rows, cols].set(cand_pin)
        cand_keys = path_keys[cand_parent].at[rows, cols].set(pkeys[cand_pin])
        cand_dead = cand_cost >= BIG
        cand_cost = jnp.where(cand_dead, BIG, cand_cost).astype(pos.dtype)

        keep = _heap_order(cand_cost, cand_keys)[:bw]

        new_paths = cand_paths[keep]
        new_keys = cand_keys[keep]
        new_cost = cand_cost[keep]
        new_current = cand_pin[keep]
        new_visited = visited[cand_parent[keep]].at[
            jnp.arange(bw), new_current].set(True)

        # freeze once the path is complete (count-1 expansions done)
        active = (step + 1) <= (count - 1)
        paths = jnp.where(active, new_paths, paths)
        path_keys = jnp.where(active, new_keys, path_keys)
        visited = jnp.where(active, new_visited, visited)
        cost = jnp.where(active, new_cost, cost)
        current = jnp.where(active, new_current, current)
        return (paths, path_keys, visited, cost, current), None

    (paths, path_keys, visited, cost, current), _ = jax.lax.scan(
        round_, (paths, path_keys, visited, cost, current), jnp.arange(m - 1))

    # final heap pop: min (cost, lexicographic path)
    best = _heap_order(cost, path_keys)[0]
    return paths[best]


def pin_outlier_index(pos, mask) -> jnp.ndarray:
    """Index of the pin farthest from the net centroid (pin_outlier:1326;
    np.argmax => first max wins ties).

    In f32 the distances are compared as ``|count * pin - sum|^2``: every
    term is an integer below 2^24, so the comparison is exact and the same
    on every backend. (A rounded centroid would let the GPU's fused
    multiply-adds break mathematically tied distances differently from the
    CPU, and the beam route starts from this pin.) Under x64 the reference's
    own f64 norm is kept, rounding noise included."""
    count = jnp.sum(mask)
    total = jnp.sum(jnp.where(mask[:, None], pos, 0.0), axis=0)
    n = jnp.maximum(count, 1).astype(pos.dtype)
    if pos.dtype == jnp.float64:
        d = jnp.linalg.norm(pos - total / n, axis=1)
    else:
        diff = pos * n - total
        d = jnp.sum(diff * diff, axis=1)
    return jnp.argmax(jnp.where(mask, d, -1.0))


def beam_route(params: EnvParams, pos, mask, beam_width: int) -> tuple:
    """Routes for all nets via beam search -> (segments f32[N, M-1, 4],
    validity bool[N, M-1])."""
    m = params.max_num_pins_per_net
    # coordinates lie in [-1, size - 1] (-1 = not placed)
    table = sqrt_table(params.height ** 2 + params.width ** 2, pos.dtype)

    def one(net_pos, net_mask):
        start = pin_outlier_index(net_pos, net_mask)
        path = beam_search_net(net_pos, net_mask, beam_width, start, table)
        cnt = jnp.sum(net_mask)
        a = path[:-1]
        b = path[1:]
        seg = jnp.concatenate(
            [net_pos[jnp.clip(a, 0, m - 1)], net_pos[jnp.clip(b, 0, m - 1)]],
            axis=-1)
        seg_valid = (jnp.arange(m - 1) < (cnt - 1)) & (a >= 0) & (b >= 0)
        return seg, seg_valid

    return jax.vmap(one)(pos, mask)


# ---------------------------------------------------------------------------
# Crossing count + wirelength (find_num_intersection:663, find_wirelength:741)
# ---------------------------------------------------------------------------

def _pairwise_intersect(seg_a, seg_b):
    """is_intersect (dummy_env_rectangular_pin.py:687-739), vectorized over
    leading dims: shared endpoint => True; parallel (det == 0) => False;
    otherwise the line-line crossing point must lie on both segments.

    Evaluated as orientation sign tests instead of computing the division
    px/py and box-comparing it (the reference's formulation): for det != 0
    the crossing point lies on segment RS iff R and S sit on opposite sides
    of (or on) line PQ, and symmetrically for PQ against line RS — the same
    predicate in real arithmetic, but free of division/FMA rounding. With
    integer endpoint coordinates (or integer-scaled ones, see
    ``count_crossings``) every intermediate is an exact small integer, so
    the result is identical in f32, f64, and across differently-fused XLA
    programs."""
    x1, y1, x2, y2 = jnp.moveaxis(seg_a, -1, 0)
    x3, y3, x4, y4 = jnp.moveaxis(seg_b, -1, 0)

    same = (((x1 == x3) & (y1 == y3)) | ((x1 == x4) & (y1 == y4))
            | ((x2 == x3) & (y2 == y3)) | ((x2 == x4) & (y2 == y4)))

    det = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)

    def orient(ax, ay, bx, by, cx, cy):
        return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)

    o1 = orient(x1, y1, x2, y2, x3, y3)
    o2 = orient(x1, y1, x2, y2, x4, y4)
    o3 = orient(x3, y3, x4, y4, x1, y1)
    o4 = orient(x3, y3, x4, y4, x2, y2)
    opp_rs = ((o1 >= 0) & (o2 <= 0)) | ((o1 <= 0) & (o2 >= 0))
    opp_pq = ((o3 >= 0) & (o4 <= 0)) | ((o3 <= 0) & (o4 >= 0))
    return same | ((det != 0) & opp_rs & opp_pq)


def _pairwise_intersect_ref_float(seg_a, seg_b):
    """The reference's LITERAL floating-point formulation
    (is_intersect:687-739): shared-endpoint tuple equality, det test,
    division-based crossing point, inclusive bounding-box check.

    The exact sign-test predicate above and this one agree everywhere the
    crossing point is robustly inside/outside — but the reference divides in
    f64, and that rounding can push a touching intersection (crossing point
    exactly on a segment endpoint, reachable with fractional centroid
    endpoints) just outside the box, MISSING an intersection the exact
    predicate counts (observed: pin_nonsquare parity seed 13, segments
    ((4,1),(3.8,1.2)) x ((4,2),(4.0,0.666...))). Fixed-seed parity means
    reproducing the reference's rounding, not improving on it, so the x64
    parity path evaluates THIS predicate on the raw (unscaled) coordinates;
    production f32 keeps the exact integer predicate, whose deviation is
    bounded by tests/parity's f32 envelope test and which gives the same
    count however XLA fuses the program.

    With all-integer endpoints (beam routes) the two predicates agree: every
    operand is exactly representable and a rational crossing point p/q can't
    fall within one ulp of an integer bound unless it IS that bound."""
    x1, y1, x2, y2 = jnp.moveaxis(seg_a, -1, 0)
    x3, y3, x4, y4 = jnp.moveaxis(seg_b, -1, 0)

    same = (((x1 == x3) & (y1 == y3)) | ((x1 == x4) & (y1 == y4))
            | ((x2 == x3) & (y2 == y3)) | ((x2 == x4) & (y2 == y4)))

    det = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    safe_det = jnp.where(det == 0, 1.0, det)
    a = x1 * y2 - y1 * x2
    b = x3 * y4 - y3 * x4
    x = (a * (x3 - x4) - (x1 - x2) * b) / safe_det
    y = (a * (y3 - y4) - (y1 - y2) * b) / safe_det
    on_both = ((jnp.minimum(x1, x2) <= x) & (x <= jnp.maximum(x1, x2))
               & (jnp.minimum(x3, x4) <= x) & (x <= jnp.maximum(x3, x4))
               & (jnp.minimum(y1, y2) <= y) & (y <= jnp.maximum(y1, y2))
               & (jnp.minimum(y3, y4) <= y) & (y <= jnp.maximum(y3, y4)))
    return same | ((det != 0) & on_both)


def count_crossings(segs, seg_valid, scale=None) -> jnp.ndarray:
    """Number of intersecting cross-net segment pairs.

    ``segs`` f32[N, M, 4], ``seg_valid`` bool[N, M]. Only pairs from
    different nets are counted, each unordered pair once
    (find_num_intersection:663-685).

    ``scale`` f32[N] (optional): per-net denominator when ``segs`` carries
    integer-scaled coordinates (``centroid_route``'s ``seg_scaled`` stores
    pin*count and the centroid as the raw coordinate sum). Each cross-net
    pair is brought to the common frame scale_a*scale_b, keeping every
    coordinate an exact small integer (<= grid*max_ppn^2), which makes the
    intersection predicate exact arithmetic.
    """
    n, m, _ = segs.shape
    flat = segs.reshape(n * m, 4)
    valid = seg_valid.reshape(n * m)
    net = jnp.repeat(jnp.arange(n), m)

    if flat.dtype == jnp.float64:
        # x64 parity mode: the reference's own f64 predicate on the RAW
        # coordinates (callers pass unscaled segments under x64) — see
        # _pairwise_intersect_ref_float for why exact arithmetic is wrong
        # here.
        hit = _pairwise_intersect_ref_float(flat[:, None, :],
                                            flat[None, :, :])
    elif scale is None:
        hit = _pairwise_intersect(flat[:, None, :], flat[None, :, :])
    else:
        s = jnp.repeat(scale, m)
        a = flat[:, None, :] * s[None, :, None]   # pair (i, j): A_i * s_j
        b = flat[None, :, :] * s[:, None, None]   # pair (i, j): B_j * s_i
        hit = _pairwise_intersect(a, b)
    pair_ok = (net[:, None] < net[None, :]) & valid[:, None] & valid[None, :]
    return jnp.sum(hit & pair_ok).astype(jnp.int32)


def wirelength(segs, seg_valid) -> jnp.ndarray:
    d = jnp.hypot(segs[..., 0] - segs[..., 2], segs[..., 1] - segs[..., 3])
    return jnp.sum(jnp.where(seg_valid, d, 0.0))


# ---------------------------------------------------------------------------
# Reward composition (find_reward:832-975)
# ---------------------------------------------------------------------------

def terminal_reward(params: EnvParams, pin_abs_x, pin_abs_y, pin_net,
                    placed_all) -> tuple:
    """Reward + (info_wirelength, info_intersections) for an episode end.

    ``placed_all`` False selects the worst-case penalty branch
    (find_reward:898-909): the raw upper bounds are surfaced in info while
    the reward uses their normalized values.
    """
    wl_norm = params.wirelength_normalizer
    int_norm = params.intersections_normalizer
    lam_w = params.weight_wirelength
    lam_i = params.weight_num_intersections

    pos, mask, _ = net_pin_table(params, pin_abs_x, pin_abs_y, pin_net)

    if params.reward_type in ("centroid", "both"):
        c_segs, c_valid, c_scaled, c_scale = centroid_route(pos, mask)
        if c_segs.dtype == jnp.float64:
            # x64 parity: the reference's f64 predicate on raw coordinates
            # (count_crossings dispatches on dtype)
            c_int = count_crossings(c_segs, c_valid)
        else:
            c_int = count_crossings(c_scaled, c_valid, c_scale)
        c_wl = wirelength(c_segs, c_valid)
    if params.reward_type in ("beam", "both"):
        b_segs, b_valid = beam_route(params, pos, mask,
                                     params.reward_beam_width)
        b_int = count_crossings(b_segs, b_valid)
        b_wl = wirelength(b_segs, b_valid)

    if params.reward_type == "centroid":
        n_int, wl = c_int, c_wl
    elif params.reward_type == "beam":
        n_int, wl = b_int, b_wl
    else:
        # "both": fewest crossings wins; tie -> beam (routes[0]), :951-965
        use_beam = b_int <= c_int
        n_int = jnp.where(use_beam, b_int, c_int)
        wl = jnp.where(use_beam, b_wl, c_wl)

    wl = wl / wl_norm
    n_int_f = n_int.astype(F32) / int_norm
    routed_reward = -(lam_w * wl + lam_i * n_int_f)

    penalty = -(lam_w * (params.max_wirelength / wl_norm)
                + lam_i * (params.max_num_intersections / int_norm))

    reward = jnp.where(placed_all, routed_reward, penalty)
    info_wl = jnp.where(placed_all, wl, params.max_wirelength)
    info_int = jnp.where(placed_all, n_int_f,
                         jnp.asarray(params.max_num_intersections, F32))
    return reward.astype(F32), info_wl.astype(F32), info_int.astype(F32)
