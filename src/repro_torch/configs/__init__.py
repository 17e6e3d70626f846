"""Assigned architecture configs + registry (``--arch <id>``)."""
from .registry import ARCHS, get_config, get_smoke_config, SHAPES  # noqa: F401
