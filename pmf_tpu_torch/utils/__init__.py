from .device import disable_tf32, resolve_device
from .meters import AverageMeter, RemainTime
