"""Kaldi-parity feature front-end (LPS spectrogram, hires MFCC, CMVN)."""

from rsrgan_jax.features.frontend import (FrameOptions, SpectrogramOptions,
                                          compute_spectrogram,
                                          compute_spectrogram_np,
                                          feature_window, num_frames)
from rsrgan_jax.features.mfcc import (MelOptions, MfccOptions, compute_mfcc,
                                      compute_mfcc_np, dct_matrix,
                                      hires_mfcc_options, lifter_coeffs,
                                      mel_banks)
