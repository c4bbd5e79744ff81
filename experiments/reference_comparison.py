"""Side-by-side reproduction of the reference's published PPO result
(BASELINE.md "PPO learning-curve match within seed variance").

The reference publishes exactly one trainable-result figure: the
intersection-weight sweep ``docs/source/_figures/rect_pin_rewards_weights.png``
referenced at ``docs/source/usage.rst:414-418`` — four PPO runs on the pin
environment "with a fixed value for beta [wirelength weight] and varying
values for alpha [intersection weight]", identified only as "Experiment
8..11"; the actual weight values, seeds, and model type are not recorded
anywhere in the repo, and the underlying CSVs are not committed.

**Why bit-level reproduction is infeasible here**: the reference trains via
Ray RLlib 2.2 + TensorFlow 2.11 + gym 0.22 (requirements-linux.txt), none
of which is installed in this environment (no ``ray``, no ``gym`` in the
image) — and even with them, unpublished weights/seeds leave nothing
bit-comparable. What the figure DOES pin down, and what this tool
reproduces and regression-locks, is its structure:

  1. **Ordering by weight**: a larger intersection weight makes the reward
     scale strictly more negative (reference: Experiments 8/9/11 cluster
     low, with the smallest-weight curve highest).
  2. **Trainable-curve shape**: every nonzero-weight curve starts around
     -2.1..-2.4 and rises steeply over the first ~30-40 iterations before
     flattening (reference: -2.2/-2.3 -> -1.35/-1.4 by iteration ~40).
  3. **The degenerate-weight outlier**: one curve (Experiment 10) sits far
     above the cluster (~-0.35 -> -0.2) with a small dynamic range — the
     signature of an (almost-)zero intersection weight, where the reward
     reduces to the (small) normalized-wirelength term. Our alpha=0 run
     reproduces exactly this separation.

Artifacts (committed under ``experiments/results/``):
  * ``weight_sweep_reference_comparison.png`` — two panels: the reference
    figure (quoted verbatim from ``/root/reference/docs/source/_figures/``
    when available) next to this repo's sweep on the flagship spatial
    config.
  * ``weight_sweep_reference_comparison.json`` — the quantified
    correspondences above, asserted by
    ``tests/agent/test_learning_artifact.py``.

Usage (runs only the weights missing from the committed sweep CSV):

    python experiments/reference_comparison.py --iterations 150
"""

import argparse
import csv
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))  # noqa: E402

from experiments.plot_style import (C_MUTED, C_SERIES, C_SURFACE,  # noqa: E402
                                    style_axis as _style)
from experiments.seed_sweep import RESULTS_DIR, _train_once  # noqa: E402

REFERENCE_FIGURE = ("/root/reference/docs/source/_figures/"
                    "rect_pin_rewards_weights.png")
COMPARISON_PNG = os.path.join(RESULTS_DIR,
                              "weight_sweep_reference_comparison.png")
COMPARISON_JSON = os.path.join(RESULTS_DIR,
                               "weight_sweep_reference_comparison.json")


def load_sweep_csv(path):
    """-> {weight: [row dict, ...]} sorted by iteration."""
    per_weight = {}
    if not os.path.exists(path):
        return per_weight
    with open(path) as f:
        for r in csv.DictReader(f):
            w = float(r["weight_num_intersections"])
            per_weight.setdefault(w, []).append({
                "weight_num_intersections": w,
                "training_iteration": int(float(r["training_iteration"])),
                "episode_reward_mean": float(r["episode_reward_mean"]),
                "normalized_wirelengths_mean":
                    float(r["normalized_wirelengths_mean"])
                    if r.get("normalized_wirelengths_mean") else None,
                "num_intersections_mean":
                    float(r["num_intersections_mean"])
                    if r.get("num_intersections_mean") else None,
            })
    for rows in per_weight.values():
        rows.sort(key=lambda r: r["training_iteration"])
    return per_weight


def _write_sweep_csv(path, per_weight):
    cols = ["weight_num_intersections", "training_iteration",
            "episode_reward_mean", "normalized_wirelengths_mean",
            "num_intersections_mean"]
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=cols)
        wr.writeheader()
        for w in sorted(per_weight):
            for r in per_weight[w]:
                wr.writerow({c: ("" if r.get(c) is None else r[c])
                             for c in cols})


def summarize(per_weight, model_type, iterations):
    """The correspondence facts the regression test locks."""
    def final(rows):
        tail = rows[-10:]
        return sum(r["episode_reward_mean"] for r in tail) / len(tail)

    def start(rows):
        return rows[0]["episode_reward_mean"]

    weights = sorted(per_weight)
    finals = {w: round(final(per_weight[w]), 4) for w in weights}
    starts = {w: round(start(per_weight[w]), 4) for w in weights}
    nonzero = [w for w in weights if w > 0]
    # improvement concentration: fraction of total gain reached by it. 40
    def early_gain(rows, upto=40):
        f = final(rows)
        s = rows[0]["episode_reward_mean"]
        at = next((r["episode_reward_mean"] for r in rows
                   if r["training_iteration"] >= upto), f)
        return (at - s) / (f - s) if f != s else 1.0

    return {
        "model_type": model_type,
        "iterations": iterations,
        "reference_figure": "docs/source/_figures/rect_pin_rewards_weights"
                            ".png (usage.rst:414-418)",
        "final_reward_by_weight": {str(w): finals[w] for w in weights},
        "start_reward_by_weight": {str(w): starts[w] for w in weights},
        "ordering_matches_reference": all(
            finals[a] > finals[b]
            for a, b in zip(weights, weights[1:])),
        "nonzero_weight_start_band": [
            round(min(starts[w] for w in nonzero), 4),
            round(max(starts[w] for w in nonzero), 4)],
        "zero_weight_separation":
            round(finals[0.0] - max(finals[w] for w in nonzero), 4)
            if 0.0 in per_weight and nonzero else None,
        "early_gain_fraction_by_weight": {
            str(w): round(early_gain(per_weight[w]), 3) for w in nonzero},
        "bit_level_reproduction_infeasible":
            "reference stack (ray[rllib]==2.2.0, tensorflow==2.11, "
            "gym==0.22) not installed in this image; reference publishes "
            "no weight values, seeds, or CSVs for Experiments 8-11",
    }


def plot_comparison(per_weight, out_png, model_type):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    have_ref = os.path.exists(REFERENCE_FIGURE)
    ncols = 2 if have_ref else 1
    fig, axes = plt.subplots(1, ncols, figsize=(7.2 * ncols, 4.6))
    if ncols == 1:
        axes = [axes]
    fig.patch.set_facecolor(C_SURFACE)

    if have_ref:
        img = plt.imread(REFERENCE_FIGURE)
        axes[0].imshow(img)
        axes[0].set_axis_off()
        axes[0].set_title(
            "Reference (quoted): rect_pin_rewards_weights.png\n"
            "fixed wirelength weight, varied intersection weight "
            "(values unpublished)", fontsize=9.5, color=C_MUTED)

    ax = axes[-1]
    for i, w in enumerate(sorted(per_weight)):
        rows = per_weight[w]
        ax.plot([r["training_iteration"] for r in rows],
                [r["episode_reward_mean"] for r in rows],
                color=C_SERIES[i % len(C_SERIES)], linewidth=2,
                label=f"intersection weight {w}")
    _style(ax, f"This repo: PPO on {model_type}\n"
               f"(wirelength weight fixed at the shipped config's value)")
    ax.set_xlabel("training iteration", fontsize=9.5, color=C_MUTED)
    ax.set_ylabel("episode reward mean", fontsize=9.5, color=C_MUTED)
    ax.legend(frameon=False, fontsize=8.5, loc="center right",
              labelcolor=C_MUTED)
    fig.tight_layout()
    fig.savefig(out_png, dpi=144, facecolor=C_SURFACE)
    plt.close(fig)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--type", default="rectangle_spatial_pin")
    p.add_argument("--iterations", type=int, default=150)
    p.add_argument("--weights", type=float, nargs="+",
                   default=[0.0, 0.1, 0.5, 0.9])
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    sweep_csv = os.path.join(RESULTS_DIR, f"{args.type}_weight_sweep.csv")
    per_weight = load_sweep_csv(sweep_csv)
    for w in args.weights:
        if w in per_weight and len(per_weight[w]) >= args.iterations:
            print(f"weight {w}: reusing {len(per_weight[w])} committed "
                  f"iterations", flush=True)
            continue
        print(f"weight {w}: training {args.iterations} iterations",
              flush=True)
        rows = _train_once(args.type, args.iterations, args.seed,
                           args.num_envs, args.unroll_length,
                           env_overrides={"weight_num_intersections": w})
        per_weight[w] = [{
            "weight_num_intersections": w,
            "training_iteration": int(r["training_iteration"]),
            "episode_reward_mean": r["episode_reward_mean"],
            "normalized_wirelengths_mean":
                r.get("custom_metrics/normalized_wirelengths_mean"),
            "num_intersections_mean":
                r.get("custom_metrics/num_intersections_mean"),
        } for r in rows]
        _write_sweep_csv(sweep_csv, per_weight)

    summary = summarize(per_weight, args.type, args.iterations)
    with open(COMPARISON_JSON, "w") as f:
        json.dump(summary, f, indent=2)
    plot_comparison(per_weight, COMPARISON_PNG, args.type)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
