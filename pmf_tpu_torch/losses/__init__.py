from .focal import focal_softmax_loss, one_hot
from .kl import kl_div
from .lovasz import (lovasz_softmax_loss, lovasz_softmax_loss_points,
                     lovasz_softmax_loss_points_pair)
from .perception_aware import normalized_entropy, perception_aware_losses
