"""Online serving: chunked enhancement with carried recurrent state."""

from rsrgan_jax.serving.pool import StreamPool
from rsrgan_jax.serving.streaming import StreamingEnhancer
from rsrgan_jax.serving.wav_stream import StreamingWavEnhancer

__all__ = ["StreamingEnhancer", "StreamingWavEnhancer", "StreamPool"]
