"""The binder: BindRequests to pod bindings (ref ``binder/``)."""
from .binder import Binder, BinderPlugin, BindResult, GpuSharingPlugin

__all__ = ["Binder", "BinderPlugin", "BindResult", "GpuSharingPlugin"]
