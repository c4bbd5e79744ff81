"""Committed learning-curve artifact stays honest (VERDICT r1 item 5).

``experiments/learning_curve.py`` trains the flagship spatial config on the
real chip and commits ``experiments/results/rectangle_spatial_pin_
progress.csv`` (+ plot) — the equivalent of the reference's published PPO
reward figure (docs/source/_figures/rect_pin_rewards_weights.png,
docs/source/usage.rst:414-418). This test asserts the committed table
actually shows learning, so the artifact can never silently rot into a
flat or regressing curve.
"""

import csv
import pathlib

ART = (pathlib.Path(__file__).resolve().parents[2] / "experiments" /
       "results" / "rectangle_spatial_pin_progress.csv")

# random-policy mean episode reward on this config (512 episodes, seed 1;
# printed by experiments/learning_curve.py when regenerating the artifact)
RANDOM_BASELINE = -2.13


def _rows():
    with open(ART, newline="") as f:
        return list(csv.DictReader(f))


def test_artifact_exists_and_is_long_enough():
    rows = _rows()
    assert len(rows) >= 100, len(rows)


def test_reward_improves_over_random_baseline():
    rows = _rows()
    last10 = [float(r["episode_reward_mean"]) for r in rows[-10:]]
    final = sum(last10) / len(last10)
    # ~0.9 above random on the committed run; assert with slack
    assert final > RANDOM_BASELINE + 0.5, final


def test_wirelength_falls():
    rows = _rows()
    col = "custom_metrics/normalized_wirelengths_mean"
    first5 = [float(r[col]) for r in rows[:5]]
    last10 = [float(r[col]) for r in rows[-10:]]
    assert (sum(last10) / len(last10)) < (sum(first5) / len(first5)) - 0.5


def test_intersections_do_not_regress():
    rows = _rows()
    col = "custom_metrics/num_intersections_mean"
    first10 = [float(r[col]) for r in rows[:10]]
    last10 = [float(r[col]) for r in rows[-10:]]
    assert (sum(last10) / len(last10)) <= (sum(first10) / len(first10))


def test_plot_curves_renders(tmp_path):
    """experiments/learning_curve.py's plotting path renders a PNG from
    synthetic rows (no training), so artifact regeneration can't rot."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "learning_curve", ART.parents[1] / "learning_curve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rows = [{"training_iteration": i,
             "episode_reward_mean": -2.0 + i * 0.01,
             "custom_metrics/normalized_wirelengths_mean": 2.5 - i * 0.01,
             "custom_metrics/num_intersections_mean": 0.7}
            for i in range(1, 31)]
    out = tmp_path / "curve.png"
    mod.plot_curves(rows, -2.13, str(out), "synthetic")
    assert out.stat().st_size > 10_000


# ---------------------------------------------------------------------------
# Multi-seed + weight-sweep artifacts (VERDICT r2 item 1): the committed
# sweep CSVs from experiments/seed_sweep.py must keep showing that EVERY
# seed learns past the random baseline (BASELINE.md: "match within seed
# variance") and that every intersection-weight setting's curve improves.
# ---------------------------------------------------------------------------

SEEDS_CSV = ART.parent / "rectangle_spatial_pin_seed_sweep.csv"
WEIGHTS_CSV = ART.parent / "rectangle_spatial_pin_weight_sweep.csv"


def _grouped(path, key):
    groups = {}
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            groups.setdefault(r[key], []).append(
                float(r["episode_reward_mean"]))
    return groups


def test_seed_sweep_every_seed_beats_random_baseline():
    groups = _grouped(SEEDS_CSV, "seed")
    assert len(groups) >= 3, sorted(groups)
    finals = {}
    for seed, ys in groups.items():
        assert len(ys) >= 100, (seed, len(ys))
        finals[seed] = sum(ys[-10:]) / 10
        assert finals[seed] > RANDOM_BASELINE + 0.5, (seed, finals[seed])
    # seed variance is tight: the final rewards agree closely across seeds
    spread = max(finals.values()) - min(finals.values())
    assert spread < 0.3, finals


def test_weight_sweep_every_weight_curve_improves():
    groups = _grouped(WEIGHTS_CSV, "weight_num_intersections")
    assert len(groups) >= 3, sorted(groups)
    for w, ys in groups.items():
        assert len(ys) >= 100, (w, len(ys))
        first10 = sum(ys[:10]) / 10
        last10 = sum(ys[-10:]) / 10
        # reward scales differ per weight; the invariant is improvement
        assert last10 > first10 + 0.3, (w, first10, last10)


# ---------------------------------------------------------------------------
# Second model-family artifact: the non-spatial flagship (rectangle_pin).
# ---------------------------------------------------------------------------

PIN_ART = ART.parent / "rectangle_pin_progress.csv"
PIN_RANDOM_BASELINE = -1.6536      # printed by the generating run (512 eps)


def test_rectangle_pin_artifact_learns():
    with open(PIN_ART, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) >= 100
    last10 = [float(r["episode_reward_mean"]) for r in rows[-10:]]
    final = sum(last10) / len(last10)
    # committed run: -1.08 final vs -1.65 random; assert with slack
    assert final > PIN_RANDOM_BASELINE + 0.3, final


# ---------------------------------------------------------------------------
# Reference weight-sweep correspondence (BASELINE "learning-curve match";
# VERDICT r3 item 1). docs/learning_parity.md states what corresponds and
# why bit-level RLlib reproduction is infeasible; these tests lock the
# committed artifacts to those claims.
# ---------------------------------------------------------------------------

SWEEP = (pathlib.Path(__file__).resolve().parents[2] / "experiments" /
         "results" / "rectangle_spatial_pin_weight_sweep.csv")
CMP_JSON = (pathlib.Path(__file__).resolve().parents[2] / "experiments" /
            "results" / "weight_sweep_reference_comparison.json")
CMP_PNG = CMP_JSON.with_suffix(".png")


def _sweep_by_weight():
    per = {}
    with open(SWEEP, newline="") as f:
        for r in csv.DictReader(f):
            per.setdefault(float(r["weight_num_intersections"]), []).append(
                float(r["episode_reward_mean"]))
    return per


def test_weight_sweep_covers_reference_axis():
    """Four weights incl. the alpha=0 analogue of the reference's outlier
    curve (Experiment 10), 150 iterations each."""
    per = _sweep_by_weight()
    assert set(per) == {0.0, 0.1, 0.5, 0.9}, sorted(per)
    assert all(len(v) >= 150 for v in per.values())


def test_weight_sweep_ordering_matches_reference_figure():
    """The figure's axis behavior: smaller intersection weight => strictly
    higher final reward (reference Experiments 8-11, smallest-weight curve
    highest)."""
    per = _sweep_by_weight()
    finals = {w: sum(v[-10:]) / 10 for w, v in per.items()}
    ws = sorted(finals)
    for a, b in zip(ws, ws[1:]):
        assert finals[a] > finals[b] + 0.02, (finals, a, b)


def test_weight_sweep_shape_matches_reference_figure():
    """Trainable curves start in a ~-2..-2.6 band and concentrate >85% of
    their gain in the first 40 iterations (the reference cluster flattens
    by ~iteration 40)."""
    per = _sweep_by_weight()
    for w, v in per.items():
        if w == 0.0:
            continue
        assert -2.7 < v[0] < -1.8, (w, v[0])
        final = sum(v[-10:]) / 10
        gain_40 = (v[39] - v[0]) / (final - v[0])
        assert gain_40 > 0.85, (w, gain_40)


def test_alpha_zero_start_matches_beta_times_wirelength():
    """The quantitative model behind the reference's Experiment-10 outlier
    (docs/learning_parity.md #3): with alpha=0 the start reward equals
    -beta * untrained normalized wirelength (shipped beta = 0.75)."""
    with open(SWEEP, newline="") as f:
        rows = [r for r in csv.DictReader(f)
                if float(r["weight_num_intersections"]) == 0.0]
    start_reward = float(rows[0]["episode_reward_mean"])
    start_wl = float(rows[0]["normalized_wirelengths_mean"])
    assert abs(start_reward - (-0.75 * start_wl)) < 0.02, (
        start_reward, start_wl)


def test_comparison_artifacts_committed_and_consistent():
    import json
    assert CMP_PNG.exists(), "two-panel comparison figure missing"
    with open(CMP_JSON) as f:
        s = json.load(f)
    assert s["ordering_matches_reference"] is True
    assert "not installed" in s["bit_level_reproduction_infeasible"]
    finals = {float(k): v for k, v in s["final_reward_by_weight"].items()}
    per = _sweep_by_weight()
    for w, v in per.items():
        assert abs(finals[w] - sum(v[-10:]) / 10) < 0.02, w


# ---------------------------------------------------------------------------
# Throughput PPO preset (VERDICT r3 item 3 option b): num_sgd_iter=10 is
# ~2x faster per iteration (tools/train_profile.py) and must keep the
# flagship learning outcome inside the 30-epoch seed band.
# ---------------------------------------------------------------------------

SGD10 = (pathlib.Path(__file__).resolve().parents[2] / "experiments" /
         "results" / "rectangle_spatial_pin_seed_sweep_sgd10.csv")

# 5-seed band of the RLlib-parity 30-epoch config (round 3 artifact)
BAND_LO, BAND_HI = -1.30, -1.15


def test_throughput_preset_seed_runs_committed():
    with open(SGD10, newline="") as f:
        rows = list(csv.DictReader(f))
    seeds = {r["seed"] for r in rows}
    assert len(seeds) >= 3, seeds
    assert len(rows) >= 3 * 150


def test_throughput_preset_matches_flagship_band():
    """At 10 SGD epochs (2x faster iterations), every seed's final reward
    stays inside the 30-epoch flagship band — the preset trades no
    learning quality on this task (committed run: -1.224..-1.231 vs band
    -1.217..-1.246, random baseline -2.12)."""
    per_seed = {}
    with open(SGD10, newline="") as f:
        for r in csv.DictReader(f):
            per_seed.setdefault(r["seed"], []).append(
                float(r["episode_reward_mean"]))
    for seed, v in per_seed.items():
        final = sum(v[-10:]) / 10
        assert BAND_LO < final < BAND_HI, (seed, final)
        assert final > RANDOM_BASELINE + 0.5, (seed, final)


# ---------------------------------------------------------------------------
# Third model-family artifact: an attention preset
# (RectanglePinAttnCompModel analogue — self-attention over the component
# axis, rectangle_pin_attn_component_model.py:16). Demonstrates the
# attention models LEARN, not just forward-pass.
# ---------------------------------------------------------------------------

ATTN_ART = ART.parent / "rectangle_pin_attn_component_progress.csv"
ATTN_RANDOM_BASELINE = -1.6536     # printed by the generating run (512 eps)


def test_attention_preset_artifact_learns():
    with open(ATTN_ART, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) >= 100
    last10 = [float(r["episode_reward_mean"]) for r in rows[-10:]]
    final = sum(last10) / len(last10)
    # committed run: -1.02 final vs -1.65 random; assert with slack
    assert final > ATTN_RANDOM_BASELINE + 0.3, final
    # wirelength falls alongside reward
    col = "custom_metrics/normalized_wirelengths_mean"
    first5 = [float(r[col]) for r in rows[:5]]
    last10w = [float(r[col]) for r in rows[-10:]]
    assert sum(last10w) / 10 < sum(first5) / 5


# ---------------------------------------------------------------------------
# Fourth model-family artifact: a factorized action-distribution preset
# (FactorisedActionDistributionOrientation analogue — hierarchical
# o -> x -> y sampling with marginalized masks,
# factorized_action_distributions.py:107). Demonstrates the factorized
# heads LEARN end-to-end, not just sample/logp correctly.
# ---------------------------------------------------------------------------

FACT_ART = ART.parent / "rectangle_factorized_pin_progress.csv"


def test_factorized_preset_artifact_learns():
    with open(FACT_ART, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) >= 100
    last10 = [float(r["episode_reward_mean"]) for r in rows[-10:]]
    final = sum(last10) / len(last10)
    # committed run: -1.01 final vs -1.65 random (same env as the joint
    # head's -1.02 — the hierarchical sampler trains just as well)
    assert final > ATTN_RANDOM_BASELINE + 0.3, final


# ---------------------------------------------------------------------------
# Round 5 (VERDICT r4 item 2): EVERY name in MODEL_REGISTRY has a committed
# 150-iteration learning curve improving over its random-policy baseline —
# the reference's ten-model table (docs/source/usage.rst:219-255) backed by
# training evidence, not just forward-pass tests. Baselines and margins are
# from the generating runs (experiments/learning_curve.py JSON output;
# margin ~half the observed improvement):
#   square                 17.6543 -> 24.798  (+7.14; near-perfect packing
#                                              is 25 for 2x2 comps on 10x10)
#   rectangle               6.9922 ->  9.741  (+2.75)
#   rectangle_factorized    6.9922 ->  9.968  (+2.98; exercises the
#                                              "coordinates" factorization
#                                              order in real training —
#                                              configs/rectangle_model_
#                                              factorized.json)
#   rectangle_pin_attn_all -1.6536 -> -1.022  (+0.63)
#   rectangle_pin_attn_all_no_grid -1.6536 -> -1.052 (+0.60)
#   rectangle_pin_all_attn_factorized -1.6536 -> -0.996 (+0.66)
# (the other four families are locked by the tests above and the spatial
# seed band.)
# ---------------------------------------------------------------------------

REGISTRY_CURVES = {
    "square": (17.6543, 3.0),
    "rectangle": (6.9922, 1.2),
    "rectangle_factorized": (6.9922, 1.2),
    "rectangle_pin": (-1.6536, 0.3),
    "rectangle_pin_attn_component": (-1.6536, 0.3),
    "rectangle_pin_attn_all": (-1.6536, 0.3),
    "rectangle_factorized_pin": (-1.6536, 0.3),
    "rectangle_pin_all_attn_factorized": (-1.6536, 0.3),
    "rectangle_pin_attn_all_no_grid": (-1.6536, 0.3),
    "rectangle_spatial_pin": (-2.13, 0.5),
}


def test_registry_curve_table_covers_the_registry():
    from placement_tpu.models.zoo import MODEL_REGISTRY
    assert set(REGISTRY_CURVES) == set(MODEL_REGISTRY)


def test_every_registry_preset_has_an_improving_curve():
    for name, (baseline, margin) in REGISTRY_CURVES.items():
        path = ART.parent / f"{name}_progress.csv"
        assert path.exists(), name
        assert (ART.parent / f"{name}_learning_curve.png").exists() or \
            name == "rectangle_spatial_pin", name  # spatial ships seed band
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) >= 100, (name, len(rows))
        last10 = [float(r["episode_reward_mean"]) for r in rows[-10:]]
        final = sum(last10) / len(last10)
        assert final > baseline + margin, (name, final, baseline)
