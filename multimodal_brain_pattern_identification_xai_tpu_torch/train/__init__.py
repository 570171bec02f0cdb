"""Training layer (counterpart of the JAX package's ``train/``): losses,
metrics, learning-rate schedules, the optimizer and train state, train and
eval steps with the NaN sentinel, the epoch-loop trainer, checkpoints,
cross-validation, checkpoint analysis, the DiffEEG diffusion trainer and
the grid search."""

from .losses import (kldiv_with_logits, kldiv_with_log_probs,  # noqa: F401
                     cross_entropy_with_logits, l2_regularization)
from .metrics import (Evaluator, macro_precision_recall_f1,  # noqa: F401
                      confusion_matrix, hard_accuracy, soft_accuracy)
from .schedules import (warmup_cosine_schedule,  # noqa: F401
                        linear_warmup_cosine_annealing,
                        cosine_schedule_with_warmup, step_decay,
                        ReduceLROnPlateau)
from .state import (Optimizer, TrainState, apply_gradients,  # noqa: F401
                    create_train_state, freeze_except, make_optimizer,
                    set_learning_rate)
from .steps import make_train_step, make_eval_step  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
from .cv import (group_kfold, stratified_kfold, run_cv,  # noqa: F401
                 detect_class_imbalance)
from .init import initialize_kaiming_weights  # noqa: F401
from .analyze import analyze_checkpoints  # noqa: F401
from .diffeeg_trainer import DiffEEGTrainer  # noqa: F401
from .grid_search import (init_candidates, make_grid_step,  # noqa: F401
                          parallel_grid_search)
