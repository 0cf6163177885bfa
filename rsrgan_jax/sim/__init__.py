"""Reverberant-data simulation (wav-reverberate + recipe equivalents)."""

from rsrgan_jax.sim.reverb import (Noise, Rir, Room, SimulationOptions,
                                   corrupt_utterance, early_reverb_energy,
                                   extend_to_duration, fft_convolve,
                                   mix_at_snr, parse_noise_list,
                                   parse_rir_list,
                                   pick_item_with_probability, reverberate)
from rsrgan_jax.sim.synthwav import (make_colored_noise, make_sim_assets,
                                     make_speech_like_wav,
                                     make_synthetic_rir)
from rsrgan_jax.sim.wavio import read_wav, write_wav
