from .device import resolve_device
from .meters import AverageMeter, RemainTime
