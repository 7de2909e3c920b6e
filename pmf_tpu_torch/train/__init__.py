from .checkpoint import CheckpointManager, partial_load
from .optim import HybridOptimizer, ScheduledOptimizer, adamw
from .schedules import warmup_cosine_lr
from .steps import (LossConfig, make_pmf_eval_step, make_pmf_train_step,
                    make_salsanext_eval_step, make_salsanext_train_step, pmf_losses,
                    salsanext_losses)
from .trainer import Trainer, config_focal_alpha, kitti_focal_alpha, nuscenes_focal_alpha
