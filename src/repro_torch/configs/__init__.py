"""Ported architecture configs. Importing this package registers them.

Only ``rwkv6-7b`` is ported so far, with the RWKV-6 serving path; the
reference's other nine configs (``src/repro/configs/``) arrive with the
slices that port their layers (ROADMAP queue 1 item 14). ``<arch>.py``
holds the exact published config; ``smoke.py`` derives reduced
same-family configs for CPU tests; ``shapes.py`` holds the four input
shapes.
"""
from . import rwkv6_7b
from .shapes import SHAPES, ShapeSpec, applicable
from .smoke import smoke_config

ALL_ARCHS = ["rwkv6-7b"]
