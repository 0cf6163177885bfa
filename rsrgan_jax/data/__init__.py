"""Data layer: Kaldi codecs, utterance store, batchers."""

from rsrgan_jax.data.kaldi_ark import (ArkWriter, ScpReader, iter_ark,
                                       read_ark_matrix, read_scp)
from rsrgan_jax.data.cmvn import (Cmvn, CmvnAccumulator, cmvn_from_stats,
                                  convert_cmvn_to_numpy, load_cmvn_npz,
                                  read_kaldi_cmvn, write_kaldi_cmvn)
from rsrgan_jax.data.splice import splice_frames, splice_frames_np
from rsrgan_jax.data.store import (StoreWriter, UtteranceStore,
                                   build_store_from_scp, read_list_file)
from rsrgan_jax.data.dataset import (FrameBatcher,
                                     HostShardedFrameBatches,
                                     HostShardedSequenceBatches,
                                     SequenceBatch, SequenceBatcher,
                                     ThreadedPrefetcher, infer_batches)
