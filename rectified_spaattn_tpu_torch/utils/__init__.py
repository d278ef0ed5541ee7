from .build import BUILD_DIR
from .device import resolve_device
from .seed import set_seed
from .timing import device_sync, profiler_trace, span
from .video import save_video, save_image, to_uint8

__all__ = ["BUILD_DIR", "resolve_device", "set_seed", "device_sync",
           "profiler_trace", "span", "save_video", "save_image",
           "to_uint8"]
