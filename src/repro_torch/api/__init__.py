"""The op surface (`ops`), its policy object and its kernel registry."""
from . import ops  # noqa: F401
from .policy import (ExecutionPolicy, current_policy, default_policy,  # noqa: F401
                     policy)
from .registry import (dispatch_intercepted, register, registry,  # noqa: F401
                       set_dispatch_hook)
