"""Objective speech-enhancement metrics (beyond the reference, which
scores only indirectly via downstream Kaldi ASR WER)."""

from rsrgan_jax.eval.metrics import (feature_mse, lsd_from_lps, seg_snr,
                                     si_snr, snr, variance_ratio)
from rsrgan_jax.eval.stoi import estoi, stoi, stoi_both

__all__ = ["si_snr", "snr", "seg_snr", "lsd_from_lps", "feature_mse",
           "variance_ratio", "stoi", "estoi", "stoi_both"]
