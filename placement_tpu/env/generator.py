"""Pure-functional instance generation.

Replaces the reference's mutable generation pipeline
(``generate_instances``, dummy_env_rectangular_pin.py:1006-1035:
components -> nets -> pins -> pin/net allocation -> pin/component allocation
-> pin cell placement) with fixed-shape JAX sampling under a single PRNG key,
so a fresh instance can be drawn inside a jitted, vmapped auto-reset step.

Distributional parity notes (exact numpy bit-streams are not reproduced —
the JAX build has its own seed story; see SURVEY.md §7 "Hard parts" #1):
  * component counts/sizes: uniform ints, same bounds (generate_components:983)
  * net count: uniform, capped at total_area/2 (sample_num_nets:1043)
  * total pins: uniform in [min_ppn*nets, max_ppn*nets], capped at total area
    (sample_total_num_pins:1050)
  * pins->nets: min_ppn guaranteed per net, remainder via truncated
    multinomial with softmax(N(1/nets, 1/(net_distribution+1))) probabilities
    (allocate_pins_to_nets:1067, sample_truncated_multinomial:258)
  * pins->components: per net, components sorted by free area, count grown
    until capacity suffices, multinomial proportional to free area with
    capacity caps (allocate_pins_to_components_for_net:1171)
  * pin cells: distinct uniform cells per component
    (place_pins_on_component:1478)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from placement_tpu.env.types import EnvParams, Variant

I32 = jnp.int32


def _randint(key, lo, hi_inclusive, shape=()):
    """Uniform integer in [lo, hi_inclusive], mirroring np.random.randint(lo, hi+1)."""
    return jax.random.randint(key, shape, lo, hi_inclusive + 1, dtype=I32)


def _bincount(draws, n_bins, active):
    """counts[i] = #{t : draws[t] == i and active[t]} without a scan."""
    onehot = (draws[:, None] == jnp.arange(n_bins)[None, :]) & active[:, None]
    return jnp.sum(onehot, axis=0).astype(I32)


def _waterfill(amount, capacity):
    """Greedy in-order fill: distribute ``amount`` across bins bounded by
    ``capacity`` (earlier bins first). Vectorized O(bins). Result pinned to
    i32: under ``jax.enable_x64`` (the parity suite) integer sums promote to
    i64, which future JAX rejects when scattered into i32 state arrays."""
    before = jnp.concatenate(
        [jnp.zeros((1,), I32), jnp.cumsum(capacity)[:-1]])
    return jnp.clip(amount - before, 0, capacity).astype(I32)


def _multinomial(key, n_trials, probs, max_trials: int):
    """Multinomial via ``max_trials`` parallel categorical draws, the first
    ``n_trials`` of which count (np.random.multinomial at
    allocate_pins_to_components_for_net:1237). No sequential scan — all
    draws issue as one batched op, which keeps auto-reset off the critical
    path."""
    logits = jnp.where(probs > 0, jnp.log(jnp.maximum(probs, 1e-30)),
                       -jnp.inf)
    draws = jax.random.categorical(key, logits, shape=(max_trials,))
    active = jnp.arange(max_trials) < n_trials
    return _bincount(draws, probs.shape[0], active)


def _capped_multinomial_exact(key, n_trials, probs, caps, max_trials: int):
    """Per-trial renormalizing truncated multinomial — the exact PROCESS of
    the reference's ``sample_truncated_multinomial``
    (dummy_env_rectangular_pin.py:258-295): each trial draws one categorical
    with bins at their cap masked out (renormalization is implicit in the
    categorical). Identical distribution to the reference (the RNG stream
    differs; byte-level stream parity lives in env/compat.py). Sequential by
    construction — a ``lax.scan`` of ``max_trials`` draws — so it costs
    ~max_trials tiny kernels per reset; select with
    ``EnvParams.exact_sampling`` when fidelity in cap-bound regimes matters
    more than throughput."""
    def trial(counts, k):
        open_bin = (counts < caps) & (probs > 0)
        logits = jnp.where(open_bin, jnp.log(jnp.maximum(probs, 1e-30)),
                           -jnp.inf)
        draw = jax.random.categorical(k, logits)
        t = jnp.sum(counts)  # trials completed so far
        add = ((jnp.arange(probs.shape[0]) == draw) & (t < n_trials)
               & jnp.any(open_bin))
        return counts + add.astype(I32), None

    counts, _ = jax.lax.scan(trial, jnp.zeros_like(probs, dtype=I32),
                             jax.random.split(key, max_trials))
    return counts


def _capped_multinomial(key, n_trials, probs, caps, max_trials: int):
    """Multinomial with a per-bin cap (sample_truncated_multinomial,
    dummy_env_rectangular_pin.py:258-295).

    The reference truncates trial-by-trial (renormalizing after every draw).
    Sequential draws would serialize the whole auto-reset path, so this uses
    a small fixed number of fully-vectorized rounds — draw the remaining
    trials uncapped, clip at the caps, repeat for the overflow — and a final
    deterministic water-fill of any residue into open bins. Equal to the
    reference's sampler whenever no cap binds (the overwhelmingly common
    case); a mild redistribution-bias deviation otherwise.
    """
    counts = jnp.zeros_like(probs, dtype=I32)
    for r in range(3):
        k = jax.random.fold_in(key, r)
        remaining = n_trials - jnp.sum(counts)
        free = caps - counts
        logits = jnp.where((free > 0) & (probs > 0),
                           jnp.log(jnp.maximum(probs, 1e-30)), -jnp.inf)
        draws = jax.random.categorical(k, logits, shape=(max_trials,))
        active = jnp.arange(max_trials) < remaining
        add = _bincount(draws, probs.shape[0], active)
        counts = counts + jnp.minimum(add, free)
    residue = n_trials - jnp.sum(counts)
    counts = counts + _waterfill(residue, caps - counts)
    return counts


def generate_components(key, params: EnvParams) -> tuple:
    """Sample component count and sizes (generate_components:983-1004)."""
    c = params.max_components
    k_n, k_h, k_w = jax.random.split(key, 3)
    num = _randint(k_n, params.min_num_components, params.max_num_components)
    comp_h = _randint(k_h, params.min_component_h, params.max_component_h, (c,))
    comp_w = _randint(k_w, params.min_component_w, params.max_component_w, (c,))
    valid = jnp.arange(c) < num
    comp_h = jnp.where(valid, comp_h, 0)
    comp_w = jnp.where(valid, comp_w, 0)
    return num, comp_h, comp_w


def _allocate_pins_to_nets(key, params: EnvParams, num_nets, total_pins):
    """Number of pins for each net -> i32[N] (allocate_pins_to_nets:1067)."""
    n_max = params.max_num_nets
    k_norm, k_multi = jax.random.split(key)
    net_ids = jnp.arange(n_max)
    net_open = net_ids < num_nets

    base = jnp.where(net_open, params.min_num_pins_per_net, 0)
    extra_total = total_pins - params.min_num_pins_per_net * num_nets

    if params.max_num_pins_per_net > params.min_num_pins_per_net:
        # softmax of N(1/num_nets, 1/(net_distribution+1)) over open nets.
        samples = (1.0 / jnp.maximum(num_nets, 1)
                   + jax.random.normal(k_norm, (n_max,))
                   / (params.net_distribution + 1.0))
        logits = jnp.where(net_open, samples, -jnp.inf)
        probs = jax.nn.softmax(logits)
        cap_each = jnp.minimum(
            params.max_num_pins_per_net - params.min_num_pins_per_net,
            jnp.maximum(extra_total, 0))
        caps = jnp.where(net_open, cap_each, 0)
        max_extra = (params.max_num_pins_per_net
                     - params.min_num_pins_per_net) * n_max
        sampler = (_capped_multinomial_exact if params.exact_sampling
                   else _capped_multinomial)
        extra = sampler(
            k_multi, jnp.maximum(extra_total, 0), probs, caps, max_extra)
    else:
        extra = jnp.zeros((n_max,), I32)
    return base + extra


def _allocate_pins_to_components(key, params: EnvParams, num_components,
                                 comp_area, num_nets, net_counts):
    """Owning component for every pin slot.

    Follows allocate_pins_to_components:1129 /
    allocate_pins_to_components_for_net:1171: nets processed in order against
    a shared free-space budget; per net, components are ranked by free space,
    the receiving set is grown until its capacity covers the net, and pins are
    distributed multinomially in proportion to free space with capacity caps.

    Returns (pin_comp i32[P], pin_net i32[P], pin_chunk_local i32[P],
    num_pins i32[]) where pins are laid out grouped by net (net 0's pins
    first) exactly as the reference rebuilds ``self.pins`` (:1167-1169), and
    ``pin_chunk_local`` reproduces the reference's per-(net, component,
    round) chunk-local ``pin_id`` (:1256-1258).
    """
    c = params.max_components
    p = params.max_pins
    m_max = params.max_num_pins_per_net
    n_max = params.max_num_nets

    net_starts = jnp.concatenate(
        [jnp.zeros((1,), I32), jnp.cumsum(net_counts)[:-1]])
    num_pins = jnp.sum(net_counts, dtype=I32)

    # Per-net spread target (pin env vs spatial differ slightly):
    if params.variant == Variant.PIN_SPATIAL:
        # dummy_env_rectangular_pin_spatial.py:1103
        k0 = (params.pin_spread * num_components) // 10 + 1
    else:
        # dummy_env_rectangular_pin.py:1148-1151
        k0 = jnp.maximum(((params.pin_spread + 1) * num_components) // 10, 1)
    k0 = jnp.minimum(k0, num_components)

    def per_net(carry, inputs):
        space = carry
        net_id, net_key = inputs
        m = net_counts[net_id]
        active = net_id < num_nets

        order = jnp.argsort(-space, stable=True)          # free space desc
        sorted_space = space[order]
        csum = jnp.cumsum(sorted_space)
        # smallest k with csum[k-1] >= m, but at least k0 (grow loop :1212-1222)
        enough = csum >= m
        first_enough = jnp.argmax(enough) + 1
        k = jnp.maximum(k0, jnp.where(jnp.any(enough), first_enough, c))

        in_top = jnp.arange(c) < k

        if params.exact_sampling:
            # Reference process exactly: redraw a full multinomial over the
            # REMAINING pins each round with probabilities proportional to
            # the top-k components' CURRENT free space, clip at capacity,
            # assign in component order, repeat until done
            # (allocate_pins_to_components_for_net:1176-1264).
            def round_cond(st):
                return st[0] > 0

            def round_body(st):
                remaining, space, comp_slot, local_of, ptr, rnd = st
                w = jnp.where(in_top, space.astype(jnp.float32), 0.0)
                probs = w / jnp.maximum(jnp.sum(w), 1e-30)
                kk = jax.random.fold_in(net_key, rnd)
                logits = jnp.where(probs > 0,
                                   jnp.log(jnp.maximum(probs, 1e-30)),
                                   -jnp.inf)
                draws = jax.random.categorical(kk, logits, shape=(m_max,))
                active = jnp.arange(m_max) < remaining
                cnt = _bincount(draws, c, active)
                cnt = jnp.minimum(cnt, space)
                bounds = jnp.cumsum(cnt)
                assigned = bounds[-1]
                ranks = jnp.arange(m_max)
                slot = jnp.clip(jnp.searchsorted(bounds, ranks, side="right"),
                                0, c - 1)
                in_round = ranks < assigned
                idx = jnp.where(in_round, ptr + ranks, m_max)
                comp_slot = comp_slot.at[idx].set(
                    jnp.where(in_round, slot, comp_slot[idx]))
                local = ranks - jnp.where(slot > 0, bounds[slot - 1], 0)
                local_of = local_of.at[idx].set(
                    jnp.where(in_round, local, local_of[idx]))
                return (remaining - assigned, space - cnt, comp_slot,
                        local_of, ptr + assigned, rnd + 1)

            st = (m, sorted_space,
                  jnp.zeros((m_max + 1,), I32), jnp.zeros((m_max + 1,), I32),
                  jnp.asarray(0, I32), jnp.asarray(0, I32))
            _, space_left, comp_slot, local_arr, _, _ = jax.lax.while_loop(
                round_cond, round_body, st)
            counts = sorted_space - space_left
            ranks = jnp.arange(m_max)
            valid_rank = ranks < m
            comp_of_rank = jnp.where(valid_rank, order[comp_slot[:m_max]], -1)
            local_of_rank = jnp.where(valid_rank, local_arr[:m_max], 0)
        else:
            # one vectorized multinomial round proportional to free space
            # with capacity caps (:1237-1253), then a deterministic
            # water-fill of any capped-out remainder into open slots (sorted
            # order) — equivalent to the reference's redraw-loop whenever no
            # cap binds.
            w = jnp.where(in_top, sorted_space.astype(jnp.float32), 0.0)
            probs = w / jnp.maximum(jnp.sum(w), 1e-30)
            counts = _multinomial(net_key, m, probs, m_max)
            counts = jnp.minimum(counts, sorted_space)     # capacity cap :1251
            counts = counts + _waterfill(m - jnp.sum(counts),
                                         sorted_space - counts)

            bounds = jnp.cumsum(counts)
            ranks = jnp.arange(m_max)
            slot = jnp.clip(jnp.searchsorted(bounds, ranks, side="right"),
                            0, c - 1)
            valid_rank = ranks < m
            comp_of_rank = jnp.where(valid_rank, order[slot], -1)
            local = ranks - jnp.where(slot > 0, bounds[slot - 1], 0)
            local_of_rank = jnp.where(valid_rank, local, 0)

        # write the consumed space back through the sort permutation
        new_space = jnp.zeros_like(space).at[order].set(
            (sorted_space - counts).astype(space.dtype))
        space = jnp.where(active, new_space, space)
        comp_of_rank = jnp.where(active, comp_of_rank, -1)
        return space, (comp_of_rank, local_of_rank)

    keys = jax.random.split(key, n_max)
    space0 = comp_area.astype(I32)
    _, (comp_of, local_of) = jax.lax.scan(
        per_net, space0, (jnp.arange(n_max), keys))
    # comp_of/local_of: [N, M] by (net, rank-within-net) -> flatten to pin table
    pin_slots = jnp.arange(p)
    pin_net = jnp.searchsorted(jnp.cumsum(net_counts), pin_slots, side="right")
    pin_net = jnp.clip(pin_net, 0, n_max - 1)
    rank = pin_slots - net_starts[pin_net]
    in_use = (pin_slots < num_pins) & (pin_net < num_nets) & (rank < m_max)
    safe_rank = jnp.clip(rank, 0, m_max - 1)
    pin_comp = jnp.where(in_use, comp_of[pin_net, safe_rank], -1).astype(I32)
    pin_local = jnp.where(in_use, local_of[pin_net, safe_rank], 0).astype(I32)
    pin_net = jnp.where(in_use, pin_net, -1).astype(I32)
    return pin_comp, pin_net, pin_local, num_pins


def _place_pins_on_components(key, params: EnvParams, comp_h, comp_w,
                              pin_comp):
    """Distinct random cell (row-major order) on the owning component for each
    pin (place_pins_on_component:1478-1498). A uniform random permutation of
    each component's cells is drawn once; the component's pins, in table
    order, take successive cells — equivalent in distribution to the
    reference's sequential random.choice without replacement."""
    c = params.max_components
    p = params.max_pins
    ppc = params.max_num_pins_per_component

    # random priority per (component, cell); invalid cells pushed to the end
    scores = jax.random.uniform(key, (c, ppc))
    cell_ids = jnp.arange(ppc)
    cell_valid = cell_ids[None, :] < (comp_h * comp_w)[:, None]
    scores = jnp.where(cell_valid, scores, 2.0)
    cell_order = jnp.argsort(scores, axis=1)               # [C, ppc]

    # rank of each pin within its component (in pin-table order)
    same = (pin_comp[None, :] == pin_comp[:, None]) & (pin_comp[:, None] >= 0)
    earlier = jnp.tril(same, k=-1)
    rank = jnp.sum(earlier, axis=1)

    safe_comp = jnp.clip(pin_comp, 0, c - 1)
    safe_rank = jnp.clip(rank, 0, ppc - 1)
    cell = cell_order[safe_comp, safe_rank]
    w = jnp.maximum(comp_w[safe_comp], 1)
    rel_x = cell // w
    rel_y = cell % w
    used = pin_comp >= 0
    rel_x = jnp.where(used, rel_x, -1)
    rel_y = jnp.where(used, rel_y, -1)
    return rel_x.astype(I32), rel_y.astype(I32)


def generate_instance(key, params: EnvParams) -> dict:
    """Full instance draw. Returns a dict of state fields (pre-mask)."""
    c = params.max_components
    p = params.max_pins
    (k_comp, k_nets, k_pins, k_alloc_nets,
     k_alloc_comps, k_cells) = jax.random.split(key, 6)

    num_components, comp_h, comp_w = generate_components(k_comp, params)
    comp_area = comp_h * comp_w
    total_area = jnp.sum(comp_area, dtype=I32)

    if not params.has_pins:
        zero = jnp.zeros((p,), I32)
        return dict(
            num_components=num_components, comp_h=comp_h, comp_w=comp_w,
            comp_x=jnp.full((c,), -1, I32), comp_y=jnp.full((c,), -1, I32),
            pin_rel_x=zero - 1, pin_rel_y=zero - 1,
            pin_abs_x=zero - 1, pin_abs_y=zero - 1,
            pin_net=zero - 1, pin_comp=zero - 1, pin_local=zero,
            num_nets=jnp.asarray(0, I32), num_pins=jnp.asarray(0, I32))

    # sample_num_nets:1043 — capped at total component area / 2
    num_nets = _randint(k_nets, params.min_num_nets, params.max_num_nets)
    num_nets = jnp.minimum(num_nets, total_area // 2)
    num_nets = jnp.maximum(num_nets, 1)

    # sample_total_num_pins:1050 — capped at total component area
    total_pins = _randint(
        k_pins, params.min_num_pins_per_net * num_nets,
        params.max_num_pins_per_net * num_nets)
    total_pins = jnp.minimum(total_pins, total_area)

    net_counts = _allocate_pins_to_nets(k_alloc_nets, params, num_nets,
                                        total_pins)
    pin_comp, pin_net, pin_chunk_local, num_pins = _allocate_pins_to_components(
        k_alloc_comps, params, num_components, comp_area, num_nets, net_counts)
    rel_x, rel_y = _place_pins_on_components(k_cells, params, comp_h, comp_w,
                                             pin_comp)

    if params.variant == Variant.PIN_SPATIAL:
        # Spatial env keeps the global creation index as pin_id
        # (dummy_env_rectangular_pin_spatial.py drops the per-chunk rewrite
        # of allocate_pins_to_components_for_net). Creation order is NOT
        # table order when extras exist: generate_pins creates the base
        # block (min_ppn per net, net-grouped) first, then extras appended
        # net-by-net (allocate_pins_to_nets:1096-1127), whereas the table is
        # per-net base+extras contiguous.
        min_ppn = params.min_num_pins_per_net
        extras = jnp.maximum(net_counts - min_ppn, 0)
        extras_before = jnp.concatenate(
            [jnp.zeros((1,), I32), jnp.cumsum(extras)[:-1]])
        net_starts = jnp.concatenate(
            [jnp.zeros((1,), I32), jnp.cumsum(net_counts)[:-1]])
        slots = jnp.arange(p, dtype=I32)
        safe_net = jnp.clip(pin_net, 0, params.max_num_nets - 1)
        rank = slots - net_starts[safe_net]
        creation = jnp.where(
            rank < min_ppn,
            safe_net * min_ppn + rank,
            num_nets * min_ppn + extras_before[safe_net] + rank - min_ppn)
        pin_local = jnp.where(pin_net >= 0, creation, 0)
    else:
        pin_local = pin_chunk_local

    neg = jnp.full((p,), -1, I32)
    return dict(
        num_components=num_components, comp_h=comp_h, comp_w=comp_w,
        comp_x=jnp.full((c,), -1, I32), comp_y=jnp.full((c,), -1, I32),
        pin_rel_x=rel_x, pin_rel_y=rel_y,
        pin_abs_x=neg, pin_abs_y=neg,
        pin_net=pin_net, pin_comp=pin_comp, pin_local=pin_local,
        num_nets=num_nets, num_pins=num_pins)
