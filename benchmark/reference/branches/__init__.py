"""The spectrogram branches the reference knows, one file a model:
``branches/<model>.py``, named by a configuration's
``spectrogram.model``.  Each gives

* ``shapes(spec, pre, num_classes)``: the weight names and shapes its
  forward reads, from the configuration's ``spectrogram`` section;
* ``forward(p, x, spec, pre, q)``: (B, 3, H, W) → log-probs, plain
  float32 (``q`` rounds the inputs and weights of every conv and linear
  layer, as in :mod:`..models`);
* ``flops(spec, h, w, num_classes)``: the operations of one window at an
  (h, w) plane, a multiply-add counted as 2.
"""

from __future__ import annotations

import importlib
import re
from types import ModuleType

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def named(package: str, model: str, what: str) -> ModuleType:
    """The module ``<package>.<model>``; ValueError, naming the file to
    add, where there is none."""
    if _NAME.match(model):
        try:
            return importlib.import_module(f"{package}.{model}")
        except ModuleNotFoundError as e:
            if e.name != f"{package}.{model}":
                raise
    raise ValueError(f"no {what} for the spectrogram model {model!r}: add "
                     f"{package.replace('.', '/')}/{model}.py")


def get(model: str) -> ModuleType:
    """``branches/<model>.py``."""
    return named(__name__, model, "reference")
