from .device import disable_tf32, resolve_device
from .flops import H100_BF16_PEAK_FLOPS, H100_F32_PEAK_FLOPS, count_flops, mfu
from .logger import is_main_process, make_logger
from .meters import AverageMeter, RemainTime
