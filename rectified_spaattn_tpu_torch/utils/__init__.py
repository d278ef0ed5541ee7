from .build import BUILD_DIR
from .device import resolve_device
from .seed import set_seed
from .timing import StageTimer, device_sync, profiler_trace
from .video import save_video, save_image, to_uint8

__all__ = ["BUILD_DIR", "resolve_device", "set_seed", "StageTimer",
           "device_sync", "profiler_trace", "save_video", "save_image",
           "to_uint8"]
