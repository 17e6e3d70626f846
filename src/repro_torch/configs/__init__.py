"""Assigned architecture configs + registry (``--arch <id>``)."""
from .registry import (ARCHS, PORT_ARCHS, SHAPES, get_config,  # noqa: F401
                       get_smoke_config)
