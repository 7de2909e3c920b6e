from .device import disable_tf32, resolve_device
from .logger import is_main_process, make_logger
from .meters import AverageMeter, RemainTime
