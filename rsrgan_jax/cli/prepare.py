"""Data preparation CLI — stage 0/1 of the reference run scripts.

Subcommands:

* ``cmvn``        — convert_cmvn_to_numpy.py parity (Kaldi stats -> npz)
* ``split``       — scripts/get_train_val_scp.py parity (shuffled tr/cv split)
* ``make-store``  — io_funcs/make_tfrecords.py parity (scp pairs -> .rtu
                    store shard with CMVN applied); ``--test`` = inputs only

Example (mirrors run_gan_rnn_placeholder.sh:19-86)::

    python -m rsrgan_jax.cli.prepare cmvn --inputs=... --labels=... --save_dir=$dir
    python -m rsrgan_jax.cli.prepare split --val_size=3000 --data_dir=$dir
    python -m rsrgan_jax.cli.prepare make-store --inputs=$dir/tr/inputs.scp \
        --labels=$dir/tr/labels.scp --cmvn_dir=$dir --output_dir=$dir/stores \
        --name=tr1
"""

from __future__ import annotations

import argparse
import os
import random
import sys

from rsrgan_jax.cli import str2bool
from rsrgan_jax.data import (build_store_from_scp, convert_cmvn_to_numpy,
                             load_cmvn_npz)


def cmd_cmvn(args) -> int:
    out = convert_cmvn_to_numpy(args.inputs, args.labels, args.save_dir)
    print(f"Write to {out}")
    return 0


def cmd_split(args) -> int:
    """Shuffle paired scp lines; first val_size -> cv/, rest -> tr/
    (scripts/get_train_val_scp.py:39-66)."""
    inputs_scp = os.path.join(args.data_dir, "inputs.scp")
    labels_scp = os.path.join(args.data_dir, "labels.scp")
    with open(inputs_scp) as f:
        in_lines = f.readlines()
    with open(labels_scp) as f:
        lab_lines = f.readlines()
    assert len(in_lines) == len(lab_lines), "scp length mismatch"
    paired = list(zip(in_lines, lab_lines))
    random.Random(args.seed).shuffle(paired)
    if args.val_size >= len(paired):
        print(f"val_size {args.val_size} >= corpus {len(paired)}",
              file=sys.stderr)
        return 1
    for sub, rows in (("cv", paired[:args.val_size]),
                      ("tr", paired[args.val_size:])):
        os.makedirs(os.path.join(args.data_dir, sub), exist_ok=True)
        with open(os.path.join(args.data_dir, sub, "inputs.scp"), "w") as fi, \
                open(os.path.join(args.data_dir, sub, "labels.scp"), "w") as fl:
            for a, b in rows:
                fi.write(a)
                fl.write(b)
    print(f"Split done: {args.val_size} cv / {len(paired) - args.val_size} tr")
    return 0


def cmd_make_store(args) -> int:
    inputs_cmvn = labels_cmvn = None
    if args.apply_cmvn:
        cmvn_npz = os.path.join(args.cmvn_dir, "train_cmvn.npz")
        inputs_cmvn, labels_cmvn = load_cmvn_npz(cmvn_npz)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, args.name + ".rtu")
    labels_scp = None if args.test else args.labels
    n = build_store_from_scp(args.inputs, out_path, labels_scp,
                             inputs_cmvn,
                             None if args.test else labels_cmvn,
                             rt60_scp=args.rt60_scp)
    print(f"Wrote {n} utterances to {out_path}")
    return 0


def cmd_split_scp(args) -> int:
    """Split paired inputs/labels scp into nj aligned shards
    (scripts/split_scp.sh:46-70)."""
    split_dir = os.path.join(args.data_dir, f"split{args.nj}")
    os.makedirs(split_dir, exist_ok=True)
    for name in ("inputs", "labels"):
        path = os.path.join(args.data_dir, f"{name}.scp")
        if not os.path.isfile(path):
            if name == "labels":
                continue
            print(f"missing {path}", file=sys.stderr)
            return 1
        with open(path) as f:
            lines = f.readlines()
        per = -(-len(lines) // args.nj)
        for j in range(args.nj):
            shard = lines[j * per:(j + 1) * per]
            with open(os.path.join(split_dir, f"{name}{j + 1}.scp"),
                      "w") as fw:
                fw.writelines(shard)
    print(f"Split into {args.nj} shards under {split_dir}")
    return 0


def cmd_verify_store(args) -> int:
    """Structural store validation (io_funcs/verify_tfrecords.py parity)."""
    from rsrgan_jax.data.store import verify_store
    failed = 0
    for path in args.stores:
        try:
            n, bad = verify_store(path)
        except Exception as e:
            print(f"{path}: CORRUPT ({e})")
            failed += 1
            continue
        status = "OK" if bad == 0 else f"{bad} BAD ENTRIES"
        print(f"{path}: {n} utterances, {status}")
        failed += int(bad > 0)
    return 1 if failed else 0


def cmd_select_data(args) -> int:
    """Filter a raw text table to the utterances named in a key list
    (utils/select_data.py:12-40)."""
    with open(args.key_list) as f:
        keys = {line.split()[0] for line in f if line.strip()}
    kept = 0
    with open(args.raw_text) as fin, open(args.output, "w") as fout:
        for line in fin:
            parts = line.split()
            if parts and parts[0] in keys:
                fout.write(line)
                kept += 1
    print(f"Kept {kept}/{len(keys)} keyed lines -> {args.output}")
    return 0


def cmd_from_tfrecords(args) -> int:
    """Repack reference TFRecords (SequenceExamples) into a .rtu store."""
    from rsrgan_jax.data.tfrecords_compat import convert_tfrecords_to_store
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, args.name + ".rtu")
    n = convert_tfrecords_to_store(args.tfrecords, out_path)
    print(f"Repacked {n} utterances from {len(args.tfrecords)} "
          f"TFRecord file(s) to {out_path}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rsrgan_jax.cli.prepare")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("cmvn")
    c.add_argument("--inputs", default="data/train/inputs.cmvn")
    c.add_argument("--labels", default="data/train/labels.cmvn")
    c.add_argument("--save_dir", required=True)
    c.set_defaults(func=cmd_cmvn)

    s = sub.add_parser("split")
    s.add_argument("--val_size", type=int, required=True)
    s.add_argument("--data_dir", required=True)
    s.add_argument("--seed", type=int, default=123)
    s.set_defaults(func=cmd_split)

    m = sub.add_parser("make-store")
    m.add_argument("--inputs", required=True)
    m.add_argument("--labels", default=None)
    m.add_argument("--cmvn_dir", default="data/train")
    m.add_argument("--apply_cmvn", type=str2bool, nargs="?", default=True)
    m.add_argument("--output_dir", required=True)
    m.add_argument("--name", required=True)
    m.add_argument("--test", action="store_true",
                   help="inputs-only store (make_tfrecords.py --test)")
    m.add_argument("--rt60_scp", default=None,
                   help="per-utt RT60 scalars prepended as an input column "
                        "(make_tfrecords_rta.py)")
    m.set_defaults(func=cmd_make_store)

    ss = sub.add_parser("split-scp")
    ss.add_argument("--nj", type=int, required=True)
    ss.add_argument("--data_dir", required=True)
    ss.set_defaults(func=cmd_split_scp)

    v = sub.add_parser("verify-store")
    v.add_argument("stores", nargs="+")
    v.set_defaults(func=cmd_verify_store)

    sd = sub.add_parser("select-data")
    sd.add_argument("--key_list", required=True)
    sd.add_argument("--raw_text", required=True)
    sd.add_argument("--output", required=True)
    sd.set_defaults(func=cmd_select_data)

    t = sub.add_parser("from-tfrecords")
    t.add_argument("--tfrecords", nargs="+", required=True)
    t.add_argument("--output_dir", required=True)
    t.add_argument("--name", required=True)
    t.set_defaults(func=cmd_from_tfrecords)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
