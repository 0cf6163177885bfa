"""Speech dereverberation GAN framework on JAX.

A ground-up JAX/XLA rebuild of the capabilities of wangkenpu/rsrgan
(reference: /root/reference): LPS->MFCC dereverberation front-ends trained
with MSE or LSGAN objectives, Kaldi-format feature I/O, and ark-compatible
enhancement output for downstream WFST decoding.

Layer map (mirrors SURVEY.md section 7):
  data/      Kaldi ark/scp + CMVN codecs, utterance store, bucketed loaders
  features/  Kaldi-parity DSP (LPS spectrogram, hires MFCC, CMVN)
  ops/       recurrent cells (peephole+projection LSTM as lax.scan)
  models/    generator/discriminator zoo (LSTM models in plain JAX)
  training/  MSE + LSGAN trainers, EMA, schedules, accept/reject checkpoints
  parallel/  device mesh + data-parallel sharding helpers
  sim/       reverberant corpus simulation (RIR convolution + SNR mixing)
  cli/       train / decode / prepare entry points
"""

__version__ = "0.1.0"
