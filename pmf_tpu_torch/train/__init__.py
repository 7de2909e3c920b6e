from .checkpoint import CheckpointManager, partial_load
from .recorder import Recorder
from .optim import AMSGradW, HybridOptimizer, ScheduledOptimizer, adamw
from .schedules import clip_lr, warmup_cosine_lr, warmup_exp_lr, warmup_multistep_lr
from .steps import (LossConfig, make_pmf_eval_step, make_pmf_train_step,
                    make_salsanext_eval_step, make_salsanext_train_step, pmf_losses,
                    salsanext_losses)
from .trainer import (Trainer, config_focal_alpha, kitti_focal_alpha, nuscenes_focal_alpha,
                      sensat_focal_alpha)
