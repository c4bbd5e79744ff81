"""Multi-seed learning curves + intersection-weight sweep (BASELINE.md:
"PPO learning-curve match within seed variance").

The reference's published PPO evidence is a multi-curve figure of reward
for several ``weight_num_intersections`` values (docs/source/_figures/
rect_pin_rewards_weights.png, docs/source/usage.rst:414-418). This runner
produces both evidence axes on the flagship spatial config:

  * seed sweep — N seeds on the unmodified config; artifact =
    ``<type>_seed_sweep.csv`` + a mean/min-max band plot vs the
    random-policy baseline (``<type>_seed_band.png``)
  * weight sweep — reward curves for several intersection weights
    (wirelength weight fixed, as in the reference figure); artifact =
    ``<type>_weight_sweep.csv`` + overlay plot (``<type>_weight_sweep.png``)

Regression-tested by tests/agent/test_learning_artifact.py.

    python experiments/seed_sweep.py --iterations 150 --seeds 0 1 2
"""

import argparse
import csv
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))  # noqa: E402

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results")

from experiments.plot_style import (C_BASELINE, C_MUTED,  # noqa: E402
                                    C_SERIES, C_SURFACE,
                                    style_axis as _style)

C_BAND = C_SERIES[0]


def _train_once(model_type, iterations, seed, num_envs, unroll,
                env_overrides=None, num_sgd_iter=None):
    from placement_tpu.agent.ppo import PPOConfig
    from placement_tpu.agent.trainer import Trainer

    kw = {} if num_sgd_iter is None else {"num_sgd_iter": num_sgd_iter}
    cfg = PPOConfig(num_envs=num_envs, unroll_length=unroll,
                    minibatch_size=min(128, num_envs * unroll), **kw)
    trainer = Trainer(model_type, ppo_config=cfg,
                      env_overrides=env_overrides or {},
                      use_tensorboard=False)
    rows = []

    def keep(it, row):
        rows.append(dict(row))
        if it % 25 == 0 or it == 1:
            print(f"  iter {it}: reward="
                  f"{row.get('episode_reward_mean'):.4f}", flush=True)

    trainer.run(num_iterations=iterations, seed=seed, on_iteration=keep)
    trainer.close()
    return rows


def plot_seed_band(per_seed, baseline, out_png, model_type):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_it = min(len(r) for r in per_seed.values())
    it = list(range(1, n_it + 1))
    series = [[r[i]["episode_reward_mean"] for r in per_seed.values()]
              for i in range(n_it)]
    mean = [sum(v) / len(v) for v in series]
    lo = [min(v) for v in series]
    hi = [max(v) for v in series]

    fig, ax = plt.subplots(figsize=(7.2, 4.2))
    fig.patch.set_facecolor(C_SURFACE)
    ax.fill_between(it, lo, hi, color=C_BAND, alpha=0.18, linewidth=0,
                    label=f"min–max over {len(per_seed)} seeds")
    ax.plot(it, mean, color=C_BAND, linewidth=2, label="mean")
    ax.axhline(baseline, color=C_BASELINE, linewidth=1.2,
               linestyle=(0, (4, 3)))
    ax.annotate(f"random policy: {baseline:.3f}", xy=(it[-1], baseline),
                xytext=(-4, 5), textcoords="offset points", ha="right",
                fontsize=8.5, color=C_MUTED)
    _style(ax, f"PPO on {model_type} — episode reward, "
               f"{len(per_seed)} seeds")
    ax.set_xlabel("training iteration", fontsize=9.5, color=C_MUTED)
    ax.legend(frameon=False, fontsize=8.5, loc="lower right",
              labelcolor=C_MUTED)
    fig.tight_layout()
    fig.savefig(out_png, dpi=144, facecolor=C_SURFACE)
    plt.close(fig)


def plot_weight_sweep(per_weight, out_png, model_type):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7.2, 4.2))
    fig.patch.set_facecolor(C_SURFACE)
    for i, (w, rows) in enumerate(sorted(per_weight.items())):
        it = [r["training_iteration"] for r in rows]
        ys = [r["episode_reward_mean"] for r in rows]
        ax.plot(it, ys, color=C_SERIES[i % len(C_SERIES)], linewidth=2,
                label=f"intersection weight {w}")
    _style(ax, f"PPO on {model_type} — reward for varied intersection "
               f"weights (wirelength weight fixed)")
    ax.set_xlabel("training iteration", fontsize=9.5, color=C_MUTED)
    ax.legend(frameon=False, fontsize=8.5, loc="lower right",
              labelcolor=C_MUTED)
    fig.tight_layout()
    fig.savefig(out_png, dpi=144, facecolor=C_SURFACE)
    plt.close(fig)


def _write_csv(path, rows, extra_cols):
    cols = list(extra_cols) + ["training_iteration", "episode_reward_mean",
                               "normalized_wirelengths_mean",
                               "num_intersections_mean"]
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=cols)
        wr.writeheader()
        for r in rows:
            wr.writerow({c: r.get(c, "") for c in cols})


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--type", default="rectangle_spatial_pin")
    p.add_argument("--iterations", type=int, default=150)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--weights", type=float, nargs="+",
                   default=[0.1, 0.5, 0.9])
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--skip-weights", action="store_true")
    p.add_argument("--skip-seeds", action="store_true")
    p.add_argument("--num-sgd-iter", type=int, default=None,
                   help="override PPOConfig.num_sgd_iter (the RLlib-parity "
                        "default is 30; 10 is the documented throughput "
                        "preset, ~2x faster per iteration)")
    p.add_argument("--tag", default="",
                   help="artifact filename suffix, e.g. _sgd10")
    args = p.parse_args()

    import jax
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from placement_tpu.agent.random_policy import simulate
    from placement_tpu.utils.config import load_experiment

    os.makedirs(RESULTS_DIR, exist_ok=True)
    env_params, _, _ = load_experiment(args.type)
    baseline = float(simulate(env_params, jax.random.PRNGKey(1001),
                              512).mean())
    print(f"random-policy baseline: {baseline:.4f}", flush=True)
    summary = {"type": args.type, "iterations": args.iterations,
               "random_baseline_reward": round(baseline, 4)}

    def slim(rows, **tags):
        out = []
        for r in rows:
            out.append({
                **tags,
                "training_iteration": int(r["training_iteration"]),
                "episode_reward_mean": r["episode_reward_mean"],
                "normalized_wirelengths_mean":
                    r.get("custom_metrics/normalized_wirelengths_mean"),
                "num_intersections_mean":
                    r.get("custom_metrics/num_intersections_mean"),
            })
        return out

    if not args.skip_seeds:
        per_seed, flat = {}, []
        for seed in args.seeds:
            print(f"seed {seed}:", flush=True)
            rows = _train_once(args.type, args.iterations, seed,
                               args.num_envs, args.unroll_length,
                               num_sgd_iter=args.num_sgd_iter)
            per_seed[seed] = slim(rows, seed=seed)
            flat.extend(per_seed[seed])
        _write_csv(os.path.join(RESULTS_DIR,
                                f"{args.type}_seed_sweep{args.tag}.csv"),
                   flat, ["seed"])
        plot_seed_band(per_seed, baseline,
                       os.path.join(RESULTS_DIR,
                                    f"{args.type}_seed_band{args.tag}.png"),
                       args.type)
        summary["final_reward_by_seed"] = {
            s: round(sum(r["episode_reward_mean"] for r in rows[-10:]) / 10,
                     4)
            for s, rows in per_seed.items()}

    if not args.skip_weights:
        per_weight, flat = {}, []
        for w in args.weights:
            print(f"weight_num_intersections {w}:", flush=True)
            rows = _train_once(
                args.type, args.iterations, args.seeds[0],
                args.num_envs, args.unroll_length,
                env_overrides={"weight_num_intersections": w},
                num_sgd_iter=args.num_sgd_iter)
            per_weight[w] = slim(rows, weight_num_intersections=w)
            flat.extend(per_weight[w])
        _write_csv(os.path.join(RESULTS_DIR,
                                f"{args.type}_weight_sweep{args.tag}.csv"),
                   flat, ["weight_num_intersections"])
        plot_weight_sweep(per_weight,
                          os.path.join(RESULTS_DIR,
                                       f"{args.type}_weight_sweep{args.tag}"
                                       f".png"),
                          args.type)
        summary["final_reward_by_weight"] = {
            w: round(sum(r["episode_reward_mean"] for r in rows[-10:]) / 10,
                     4)
            for w, rows in per_weight.items()}

    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
