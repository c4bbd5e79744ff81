"""PPO learning-curve artifact generator (BASELINE.md correctness item).

Trains the named model type (default: the flagship spatial-observation
config ``rectangle_spatial_pin``) for N iterations, computes the
random-policy baseline on the same environment, and commits the evidence
the reference publishes as a figure (docs/source/_figures/
rect_pin_rewards_weights.png, docs/source/usage.rst:414-418):

  * ``experiments/results/<type>_progress.csv``       — full metric table
  * ``experiments/results/<type>_learning_curve.png`` — reward /
    normalized-wirelength / intersections vs iteration, with the
    random-policy mean as a reference line

    python experiments/learning_curve.py --iterations 150
"""

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))  # noqa: E402

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results")

from experiments.plot_style import (C_BASELINE, C_MUTED,  # noqa: E402
                                    C_SURFACE, C_TEXT, style_axis)
from experiments.plot_style import C_SERIES as _SERIES  # noqa: E402

C_SERIES = _SERIES[0]


def plot_curves(rows, baseline_reward, out_png, model_type):
    """Three stacked panels (one measure each — never dual axes)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    it = [r["training_iteration"] for r in rows]
    panels = [
        ("episode_reward_mean", "Episode reward (mean)", baseline_reward,
         "random policy"),
        ("custom_metrics/normalized_wirelengths_mean",
         "Normalized wirelength (mean)", None, None),
        ("custom_metrics/num_intersections_mean",
         "Wire crossings (mean)", None, None),
    ]
    fig, axes = plt.subplots(3, 1, figsize=(7.2, 7.8), sharex=True)
    fig.patch.set_facecolor(C_SURFACE)
    for ax, (col, title, base, base_label) in zip(axes, panels):
        ys = [r.get(col, float("nan")) for r in rows]
        ax.plot(it, ys, color=C_SERIES, linewidth=2)
        if base is not None:
            ax.axhline(base, color=C_BASELINE, linewidth=1.2,
                       linestyle=(0, (4, 3)))
            ax.annotate(f"{base_label}: {base:.3f}", xy=(it[-1], base),
                        xytext=(-4, 5), textcoords="offset points",
                        ha="right", fontsize=8.5, color=C_MUTED)
        style_axis(ax, title)
    axes[-1].set_xlabel("training iteration", fontsize=9.5, color=C_MUTED)
    fig.suptitle(f"PPO on {model_type} — learning curve",
                 x=0.125, ha="left", fontsize=12, color=C_TEXT)
    fig.tight_layout(rect=(0, 0, 1, 0.97))
    fig.savefig(out_png, dpi=144, facecolor=C_SURFACE)
    plt.close(fig)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--type", default="rectangle_spatial_pin")
    p.add_argument("--iterations", type=int, default=150)
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--baseline-episodes", type=int, default=512)
    args = p.parse_args()
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import jax
    from placement_tpu.agent.ppo import PPOConfig
    from placement_tpu.agent.random_policy import simulate
    from placement_tpu.agent.trainer import Trainer
    from placement_tpu.utils.config import load_experiment

    env_params, _, _ = load_experiment(args.type)
    base_returns = simulate(env_params, jax.random.PRNGKey(args.seed + 1),
                            args.baseline_episodes)
    baseline = float(base_returns.mean())
    print(f"random-policy baseline: {baseline:.4f} "
          f"(n={args.baseline_episodes})", flush=True)

    cfg = PPOConfig(num_envs=args.num_envs,
                    unroll_length=args.unroll_length,
                    minibatch_size=min(128,
                                       args.num_envs * args.unroll_length))
    trainer = Trainer(args.type, ppo_config=cfg)
    rows = []

    def report(it, row):
        rows.append(dict(row))
        if it % 10 == 0 or it == 1:
            print(f"iter {it}: reward={row.get('episode_reward_mean'):.4f} "
                  f"wl={row.get('custom_metrics/normalized_wirelengths_mean', float('nan')):.4f} "
                  f"int={row.get('custom_metrics/num_intersections_mean', float('nan')):.4f}",
                  flush=True)

    result = trainer.run(num_iterations=args.iterations, seed=args.seed,
                         on_iteration=report)
    trainer.close()

    os.makedirs(RESULTS_DIR, exist_ok=True)
    shutil.copy(os.path.join(result.run_dir, "progress.csv"),
                os.path.join(RESULTS_DIR, f"{args.type}_progress.csv"))
    out_png = os.path.join(RESULTS_DIR, f"{args.type}_learning_curve.png")
    plot_curves(rows, baseline, out_png, args.type)

    last10 = rows[-10:]
    final = sum(r["episode_reward_mean"] for r in last10) / len(last10)
    print(json.dumps({
        "type": args.type, "iterations": args.iterations,
        "random_baseline_reward": round(baseline, 4),
        "final_reward_mean_last10": round(final, 4),
        "improvement": round(final - baseline, 4),
        "run_dir": result.run_dir, "plot": out_png,
    }), flush=True)


if __name__ == "__main__":
    main()
