"""Ported architecture configs. Importing this package registers them.

``rwkv6-7b`` is ported with the RWKV-6 serving and training paths, and
``lm-100m`` (the training launcher's default, registered as in the
reference and outside ``ALL_ARCHS``) waits for its attention layers; the
reference's other nine configs (``src/repro/configs/``) arrive with the
slices that port their layers (ROADMAP queue 1 item 2.2). ``<arch>.py``
holds the exact published config; ``smoke.py`` derives reduced
same-family configs for CPU tests; ``shapes.py`` holds the four input
shapes.
"""
from . import lm_100m, rwkv6_7b
from .shapes import SHAPES, ShapeSpec, applicable
from .smoke import smoke_config

ALL_ARCHS = ["rwkv6-7b"]
