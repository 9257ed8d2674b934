from .config import default_float, enable_x64, resolve_device, x64_enabled

__all__ = ["default_float", "enable_x64", "resolve_device", "x64_enabled"]
