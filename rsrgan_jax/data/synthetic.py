"""Synthetic corpus generation for tests, recipes and benchmarks.

Generates LPS-like (input_dim) / MFCC-like (output_dim) feature pairs with
a fixed linear + nonlinear relationship so trainers have something
learnable, writes them as Kaldi arks + scp + CMVN stats — i.e. exactly the
artifacts the reference expects from its Kaldi front-end
(/root/reference/README.md:33-35).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from rsrgan_jax.data.cmvn import CmvnAccumulator, write_kaldi_cmvn
from rsrgan_jax.data.kaldi_ark import ArkWriter


def make_synthetic_corpus(data_dir: str, num_utts: int = 20,
                          input_dim: int = 257, output_dim: int = 40,
                          min_len: int = 150, max_len: int = 400,
                          seed: int = 0) -> Tuple[str, str]:
    """Write inputs.ark/scp, labels.ark/scp and {inputs,labels}.cmvn.

    Returns (inputs_scp, labels_scp).
    """
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(input_dim, output_dim)).astype(np.float32) * 0.05

    in_scp = os.path.join(data_dir, "inputs.scp")
    lab_scp = os.path.join(data_dir, "labels.scp")
    in_ark = os.path.join(data_dir, "inputs.ark")
    lab_ark = os.path.join(data_dir, "labels.ark")
    for path in (in_ark, lab_ark):
        if os.path.exists(path):
            os.remove(path)

    win = ArkWriter(in_scp)
    wlab = ArkWriter(lab_scp)
    acc_i = CmvnAccumulator(input_dim)
    acc_l = CmvnAccumulator(output_dim)
    for i in range(num_utts):
        T = int(rng.integers(min_len, max_len + 1))
        x = rng.normal(loc=2.0, scale=3.0,
                       size=(T, input_dim)).astype(np.float32)
        y = (np.tanh(x @ w)
             + 0.01 * rng.normal(size=(T, output_dim))).astype(np.float32)
        utt = f"utt{i:04d}"
        win.write_next_utt(in_ark, utt, x)
        wlab.write_next_utt(lab_ark, utt, y)
        acc_i.accumulate(x)
        acc_l.accumulate(y)
    win.close()
    wlab.close()
    write_kaldi_cmvn(os.path.join(data_dir, "inputs.cmvn"),
                     acc_i.stats_matrix())
    write_kaldi_cmvn(os.path.join(data_dir, "labels.cmvn"),
                     acc_l.stats_matrix())
    return in_scp, lab_scp
