"""Training layer: LSGAN + MSE trainers, schedules, EMA, checkpoints."""

from rsrgan_jax.training.checkpoints import (latest_checkpoint,
                                             load_checkpoint,
                                             load_newest_state,
                                             read_checkpoint_meta,
                                             save_checkpoint,
                                             save_periodic_snapshot,
                                             swap_in_ema)
from rsrgan_jax.training.gan import GanState, GanTrainer, default_hparams
from rsrgan_jax.training.losses import (g_mse_loss, l2_loss_nonbias,
                                        lsgan_d_losses, lsgan_g_adv_loss)
from rsrgan_jax.training.mse import MseState, MseTrainer
from rsrgan_jax.training.schedules import (ImprovementTracker,
                                           exponential_decay, staged_decay)
from rsrgan_jax.training.state import (NetState, clip_by_norm_each,
                                       ema_update, make_optimizer)
