"""Parallel programs over torch.distributed (counterpart of the JAX
package's ``parallel/``): the (data, model, seq) device mesh and its
placements (:mod:`.mesh`), one process a rank (:mod:`.launch`; NCCL on
the card, gloo on the CPU), multi-process start-up and the rank-0 gate
(:mod:`.hosts`), the data-parallel train step (:mod:`.train`; the
``Trainer``'s and ``DiffEEGTrainer``'s ``mesh``), tensor-parallel dense
layers (:mod:`.tp`), sequence parallelism for long EEG with attention
rollout (:mod:`.seqparallel`) and the DP × TP × SP step of the multichip
dry run (:mod:`.dryrun`)."""

from .mesh import (make_mesh, batch_sharding, replicate,  # noqa: F401
                   param_shardings)
from .train import (make_parallel_train_step, shard_batch,  # noqa: F401
                    replay_dp_loss_single_device)
from .seqparallel import (halo_conv1d, sequence_parallel_attention,  # noqa: F401
                          LongEEGEncoder, long_eeg_forward, long_eeg_rollout)
from .hosts import initialize_multihost, is_primary  # noqa: F401
from .launch import spawn  # noqa: F401
from . import dryrun, launch, tp  # noqa: F401
