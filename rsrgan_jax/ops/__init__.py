"""Core compute ops: recurrent cells and shared elementwise helpers."""

from rsrgan_jax.ops.common import gaussian_noise, leakyrelu, prelu
from rsrgan_jax.ops.lstm import LstmCellP, StackedLstm
