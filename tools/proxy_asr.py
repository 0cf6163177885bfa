"""In-image recognition proxy: score enhanced features on the WER axis.

The reference's headline claim is downstream ASR WER on enhanced features
(/root/reference/README.md:45-48) via an external Kaldi decoder that does
not exist in this image. The synthetic corpus's content, however, is
chosen by the framework itself (rsrgan_jax/sim/synthwav.py
make_phone_like_wav): utterances are sequences of units from a fixed
16-way pseudo-phone inventory, with frame-level ground-truth alignments
recorded at synthesis time. This tool is the in-image stand-in for the
WER column:

1. train a small frame classifier (spliced-context MLP) on CLEAN features
   against the alignments,
2. evaluate it on each system's features ({noisy, MSE-enhanced,
   GAN-enhanced}) over the same utterances,
3. report FER (frame error rate) and SER (segment error rate: one
   majority vote per true unit segment — the closest frame-level
   analogue of word errors).

Memory/transfer design mirrors the training loop's device-resident feed:
the UNSPLICED frame table + a [N, 2c+1] clamped splice-index table live
on device; each step sends only a [batch] int32 frame selection, and the
spliced batch is assembled by an on-device gather (a host-side spliced
copy of a 1.3M-frame corpus would be ~7 GB).

Usage (see recipes/run_ablation.sh):

    python tools/proxy_asr.py --train_scp clean_tr.scp --ali_scp ali.scp \
        --eval noisy=corrupted_cv.scp --eval mse=mse/feats.scp \
        --eval gan=gan/feats.scp --holdout_scp clean_cv.scp \
        --out proxy.json

All feature scps must be in the same domain (raw LPS: the decode CLI's
denormalized output matches the clean extraction). Normalization is
computed from the classifier's training set and applied to every system.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")  # repo root when invoked as tools/proxy_asr.py

from rsrgan_jax.data.kaldi_ark import ScpReader  # noqa: E402


def read_alignments(ali_scp: str) -> dict:
    out = {}
    with open(ali_scp) as f:
        for line in f:
            utt, path = line.split()
            out[utt] = np.load(path)
    return out


def load_corpus(scp: ScpReader, ali: dict, context: int,
                utt_stride: int = 1):
    """-> (base [N, D] f32, idx [N, 2c+1] i32, y [N] i32, per-utt slices).

    base is the unspliced frame table; idx[t] are the edge-clamped global
    row indices whose concatenation is the spliced frame t
    (data/splice.py semantics). Feats/alignment lengths may drift by an
    edge frame or two (decode trims to true length); tolerate <=2, fail
    beyond. ``utt_stride`` keeps every k-th utterance (whole utterances,
    so splice windows stay intact) — used to bound the classifier's
    train-table HBM footprint at 20 h corpus scale."""
    bases, idxs, ys, slices, pos = [], [], [], {}, 0
    offsets = np.arange(-context, context + 1)
    for i, utt in enumerate(scp.utt_ids):
        if i % utt_stride:
            continue
        if utt not in ali:
            continue
        feats = scp.read_utt(utt)
        labels = ali[utt]
        n = min(feats.shape[0], len(labels))
        if abs(feats.shape[0] - len(labels)) > 2:
            raise ValueError(
                f"{utt}: {feats.shape[0]} feature frames vs "
                f"{len(labels)} alignment frames — wrong ali.scp?")
        bases.append(np.asarray(feats[:n], np.float32))
        t = np.arange(n)[:, None]
        idxs.append((np.clip(t + offsets, 0, n - 1) + pos).astype(np.int32))
        ys.append(labels[:n].astype(np.int32))
        slices[utt] = (pos, pos + n)
        pos += n
    if not bases:
        raise ValueError("no utterances overlap between the scp and ali.scp")
    return (np.concatenate(bases), np.concatenate(idxs),
            np.concatenate(ys), slices)


class ProxyClassifier:
    """Small MLP frame classifier over on-device gathered splice windows."""

    def __init__(self, in_dim: int, num_classes: int, hidden: int,
                 lr: float, seed: int):
        import jax
        import jax.numpy as jnp
        import optax

        self.jax, self.jnp = jax, jnp
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        self.params = {
            "w1": jax.random.normal(k1, (in_dim, hidden))
            * np.sqrt(2.0 / in_dim),
            "b1": jnp.zeros((hidden,)),
            "w2": jax.random.normal(k2, (hidden, hidden))
            * np.sqrt(2.0 / hidden),
            "b2": jnp.zeros((hidden,)),
            "w3": jax.random.normal(k3, (hidden, num_classes)) * 0.01,
            "b3": jnp.zeros((num_classes,)),
        }
        self.tx = optax.adam(lr)
        self.opt_state = self.tx.init(self.params)

        def assemble(base, idx, mean, std, sel):
            # idx is stored TRANSPOSED [2c+1, N]: a [N, 5] int32 table
            # tile-pads its 5 lanes to 128 (25x HBM waste — 3.5 GB at
            # 20 h corpus scale); [5, N] keeps N on the lane dim, compact.
            xb = base[idx[:, sel]]                   # [2c+1, b, D]
            xb = jnp.swapaxes(xb, 0, 1).reshape(sel.shape[0], -1)
            return (xb - mean) / std

        def logits_fn(p, xb):
            h = jax.nn.relu(xb @ p["w1"] + p["b1"])
            h = jax.nn.relu(h @ p["w2"] + p["b2"])
            return h @ p["w3"] + p["b3"]

        def loss_fn(p, xb, yb):
            return optax.softmax_cross_entropy_with_integer_labels(
                logits_fn(p, xb), yb).mean()

        @jax.jit
        def step(p, o, base, idx, mean, std, sel, y):
            xb = assemble(base, idx, mean, std, sel)
            loss, grads = jax.value_and_grad(loss_fn)(p, xb, y[sel])
            updates, o = self.tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, loss

        @jax.jit
        def predict(p, base, idx, mean, std, sel):
            return jnp.argmax(
                logits_fn(p, assemble(base, idx, mean, std, sel)), axis=-1)

        self._step, self._predict = step, predict

    def fit(self, base_d, idx_d, y_d, n: int, epochs: int, batch: int,
            seed: int, mean_d, std_d):
        jnp = self.jnp
        rng = np.random.default_rng(seed)
        steps_per_epoch = max(1, n // batch)
        for epoch in range(epochs):
            order = rng.permutation(n)
            losses = []
            for s in range(steps_per_epoch):
                sel = jnp.asarray(order[s * batch:(s + 1) * batch])
                self.params, self.opt_state, loss = self._step(
                    self.params, self.opt_state, base_d, idx_d, mean_d,
                    std_d, sel, y_d)
                losses.append(loss)
            xent = float(np.mean([float(v) for v in losses]))
            print(f"proxy classifier epoch {epoch + 1}/{epochs}: "
                  f"xent {xent:.4f}", flush=True)

    def predict_all(self, base_d, idx_d, n: int, batch: int, mean_d,
                    std_d) -> np.ndarray:
        jnp = self.jnp
        outs = []
        for s in range(0, n, batch):
            sel = jnp.asarray(np.arange(s, min(n, s + batch)))
            outs.append(self._predict(self.params, base_d, idx_d, mean_d,
                                      std_d, sel))
        return np.asarray(self.jax.device_get(jnp.concatenate(outs)))


def segment_error_rate(preds: np.ndarray, y: np.ndarray,
                       slices: dict) -> tuple:
    seg_err, seg_tot = 0, 0
    for utt, (lo, hi) in slices.items():
        labels, p = y[lo:hi], preds[lo:hi]
        bounds = np.flatnonzero(np.diff(labels)) + 1
        for a, b in zip(np.concatenate([[0], bounds]),
                        np.concatenate([bounds, [len(labels)]])):
            votes = np.bincount(p[a:b])
            seg_err += int(np.argmax(votes) != labels[a])
            seg_tot += 1
    return seg_err, seg_tot


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/proxy_asr.py")
    p.add_argument("--train_scp", required=True,
                   help="CLEAN features the classifier trains on")
    p.add_argument("--ali_scp", required=True,
                   help="frame alignments from make_sim_assets("
                        "alignments=True)")
    p.add_argument("--eval", action="append", default=[],
                   metavar="NAME=SCP", help="system to score (repeatable)")
    p.add_argument("--holdout_scp", default=None,
                   help="clean features of the EVAL utterances "
                        "(classifier sanity ceiling, reported as 'clean')")
    p.add_argument("--context", type=int, default=2,
                   help="splice context each side (input dim x(2c+1))")
    p.add_argument("--max_train_frames", type=int, default=2_500_000,
                   help="bound the train table via utterance striding "
                        "(f32 base must fit HBM next to the idx table; "
                        "2.5M frames x 257 ~= 3.8 GB padded)")
    p.add_argument("--hidden", type=int, default=192)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write JSON here too")
    args = p.parse_args(argv)

    from rsrgan_jax.sim.synthwav import NUM_PHONES

    ali = read_alignments(args.ali_scp)
    tr_scp = ScpReader(args.train_scp)
    total = sum(len(ali[u]) for u in tr_scp.utt_ids if u in ali)
    stride = max(1, -(-total // args.max_train_frames))
    if stride > 1:
        print(f"proxy classifier: {total} frames available; keeping every "
              f"{stride}th utterance (--max_train_frames "
              f"{args.max_train_frames})", flush=True)
    base, idx, y, _ = load_corpus(tr_scp, ali, args.context,
                                  utt_stride=stride)
    n, d = base.shape
    splice_n = 2 * args.context + 1
    # per-dim stats of the base table, tiled across splice columns (each
    # spliced column is a base frame, so they share statistics)
    mean = np.tile(base.mean(axis=0), splice_n)[None, :]
    std = np.tile(base.std(axis=0) + 1e-5, splice_n)[None, :]
    print(f"proxy classifier: {n} train frames, {NUM_PHONES} classes, "
          f"input dim {d * splice_n}", flush=True)

    clf = ProxyClassifier(d * splice_n, NUM_PHONES, args.hidden, args.lr,
                          args.seed)
    import jax
    base_d, idx_d, y_d = (jax.device_put(base),
                          jax.device_put(np.ascontiguousarray(idx.T)),
                          jax.device_put(y))
    mean_d, std_d = jax.device_put(mean), jax.device_put(std)
    clf.fit(base_d, idx_d, y_d, n, args.epochs, args.batch, args.seed + 1,
            mean_d, std_d)

    result = {"classes": NUM_PHONES, "context": args.context,
              "train_frames": int(n), "systems": {}}
    n_tr_eval = min(n, 200000)
    tr_preds = clf.predict_all(base_d, idx_d, n_tr_eval, args.batch,
                               mean_d, std_d)
    result["train_fer"] = round(float(np.mean(tr_preds != y[:n_tr_eval])),
                                4)
    del base_d, idx_d, y_d

    systems = []
    if args.holdout_scp:
        systems.append(("clean", args.holdout_scp))
    for spec in args.eval:
        name, scp_path = spec.split("=", 1)
        systems.append((name, scp_path))
    for name, scp_path in systems:
        b, ix, ye, slices = load_corpus(ScpReader(scp_path), ali,
                                        args.context)
        preds = clf.predict_all(jax.device_put(b),
                                jax.device_put(np.ascontiguousarray(ix.T)),
                                b.shape[0], args.batch, mean_d, std_d)
        fer = float(np.mean(preds != ye))
        seg_err, seg_tot = segment_error_rate(preds, ye, slices)
        result["systems"][name] = {
            "fer": round(fer, 4),
            "ser": round(seg_err / max(seg_tot, 1), 4),
            "frames": int(len(ye)), "segments": seg_tot}
        print(f"proxy[{name}]: FER {fer:.4f} "
              f"SER {seg_err / max(seg_tot, 1):.4f}", flush=True)

    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
