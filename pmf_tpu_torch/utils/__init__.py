from .device import resolve_device
