"""Global CMVN statistics: read Kaldi stats, accumulate, apply, denormalize.

Replaces io_funcs/convert_cmvn_to_numpy.py:19-81 plus the external Kaldi
CMVN accumulation binary (SURVEY.md section 2.8). The Kaldi global-CMVN
stats matrix has two rows::

    row 0: [ sum_x_0 ... sum_x_{D-1},  frame_count ]
    row 1: [ sumsq_0 ... sumsq_{D-1},  0          ]

mean = sum/count, stddev = sqrt(sumsq/count - mean^2).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from rsrgan_jax.data.kaldi_ark import read_matrix, write_matrix


@dataclass
class Cmvn:
    """Mean/stddev pair for one feature stream."""

    mean: np.ndarray
    stddev: np.ndarray

    def apply(self, feats: np.ndarray) -> np.ndarray:
        return (feats - self.mean) / self.stddev

    def denormalize(self, feats: np.ndarray) -> np.ndarray:
        return feats * self.stddev + self.mean


class CmvnAccumulator:
    """Streaming sum/sumsq accumulation (Kaldi compute-cmvn-stats parity)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.sum = np.zeros(dim, dtype=np.float64)
        self.sumsq = np.zeros(dim, dtype=np.float64)
        self.count = 0.0

    def accumulate(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, dtype=np.float64)
        assert feats.ndim == 2 and feats.shape[1] == self.dim
        self.sum += feats.sum(axis=0)
        self.sumsq += np.square(feats).sum(axis=0)
        self.count += feats.shape[0]

    def stats_matrix(self) -> np.ndarray:
        """Kaldi-layout [2, dim+1] float64 stats matrix."""
        stats = np.zeros((2, self.dim + 1), dtype=np.float64)
        stats[0, :-1] = self.sum
        stats[0, -1] = self.count
        stats[1, :-1] = self.sumsq
        return stats

    def finalize(self) -> Cmvn:
        return cmvn_from_stats(self.stats_matrix())


def cmvn_from_stats(stats: np.ndarray) -> Cmvn:
    """Convert a Kaldi [2, dim+1] stats matrix into mean/stddev.

    Matches convert_cmvn_to_numpy.py:34-40 exactly (no variance floor).
    """
    count = stats[0][-1]
    moments = stats[:, :-1]
    mean = moments[0] / count
    stddev = np.sqrt(moments[1] / count - mean ** 2)
    return Cmvn(mean=mean, stddev=stddev)


def read_kaldi_cmvn(path: str, offset: int = 0) -> np.ndarray:
    """Read a binary Kaldi CMVN stats matrix (convert_cmvn_to_numpy.py:52-81)."""
    with open(path, "rb") as f:
        f.seek(int(offset))
        return np.asarray(read_matrix(f), dtype=np.float64)


def write_kaldi_cmvn(path: str, stats: np.ndarray) -> None:
    """Write stats as a binary Kaldi float matrix (readable by Kaldi tools)."""
    with open(path, "wb") as f:
        write_matrix(f, np.asarray(stats, dtype=np.float32))


def convert_cmvn_to_numpy(inputs_cmvn: str, labels_cmvn: str,
                          save_dir: str) -> str:
    """Build train_cmvn.npz from two Kaldi stats files.

    Drop-in equivalent of io_funcs/convert_cmvn_to_numpy.py:19-49; the npz
    keys (mean_inputs/stddev_inputs/mean_labels/stddev_labels) are identical
    so downstream decode denormalization is unchanged.
    """
    inputs = cmvn_from_stats(read_kaldi_cmvn(inputs_cmvn))
    labels = cmvn_from_stats(read_kaldi_cmvn(labels_cmvn))
    out = os.path.join(save_dir, "train_cmvn.npz")
    np.savez(out,
             mean_inputs=inputs.mean, stddev_inputs=inputs.stddev,
             mean_labels=labels.mean, stddev_labels=labels.stddev)
    return out


def load_cmvn_npz(path: str) -> Tuple[Cmvn, Cmvn]:
    """Load train_cmvn.npz -> (inputs_cmvn, labels_cmvn)."""
    data = np.load(path)
    return (Cmvn(data["mean_inputs"], data["stddev_inputs"]),
            Cmvn(data["mean_labels"], data["stddev_labels"]))
