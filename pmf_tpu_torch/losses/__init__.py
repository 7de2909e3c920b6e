from .dice import dice_loss, explog_dice_loss
from .focal import focal_softmax_loss, one_hot
from .kl import kl_div
from .lovasz import (lovasz_softmax_loss, lovasz_softmax_loss_points,
                     lovasz_softmax_loss_points_pair)
from .multi_task import init_multi_task_params, multi_task_loss
from .perception_aware import normalized_entropy, perception_aware_loss, perception_aware_losses
from .smoothness import grad_guide_loss, smoothness_loss
from .weighted_smoothl1 import weighted_smooth_l1
