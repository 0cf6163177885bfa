"""Training-curve plots from metrics JSONL — utils/generate_plots.py
equivalent for this framework's structured logs.

    python -m rsrgan_jax.cli.plot --save_dir exp/gan_res_lstm_l \
        [--output exp/gan_res_lstm_l/curves.png]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_metrics(path):
    records = []
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    records.append(json.loads(line))
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsrgan_jax.cli.plot")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    train = load_metrics(os.path.join(args.save_dir, "metrics_train.jsonl"))
    evals = load_metrics(os.path.join(args.save_dir, "metrics_eval.jsonl"))
    if not train:
        print("no metrics_train.jsonl records found", file=sys.stderr)
        return 1

    keys = [k for k in train[0] if k != "iteration"]
    ncols = 2
    nrows = -(-len(keys) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(10, 2.6 * nrows),
                             squeeze=False)
    for idx, key in enumerate(keys):
        ax = axes[idx // ncols][idx % ncols]
        ax.plot([r["iteration"] for r in train],
                [r.get(key) for r in train], label="train")
        if evals and key in evals[0]:
            ax.plot([r["iteration"] for r in evals],
                    [r.get(key) for r in evals], label="cv")
        ax.set_title(key)
        ax.set_xlabel("iteration")
        ax.legend(fontsize=7)
    for idx in range(len(keys), nrows * ncols):
        axes[idx // ncols][idx % ncols].axis("off")
    fig.tight_layout()
    out = args.output or os.path.join(args.save_dir, "curves.png")
    fig.savefig(out, dpi=110)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
