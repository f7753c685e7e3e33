from .batching import BatchSlot, DecodeBatcher, form_batches
from .engine import Request, ServingEngine, resolve_device
from .overload import BrownoutConfig, OverloadController

__all__ = ["BatchSlot", "BrownoutConfig", "DecodeBatcher",
           "OverloadController", "Request", "ServingEngine", "form_batches",
           "resolve_device"]
