"""The program's late-fusion model for each spectrogram model, one file a
model: ``builders/<model>.py``, named by a configuration's
``spectrogram.model``.  Each gives ``build(cfg, prog, dtype)``: the port's
model for the configuration and the program (``prog``, one of its
``programs``), on the CPU in evaluation mode, its spectrogram branch in
``dtype`` (None: float32), before any weights are loaded.  Its weights
are then loaded strictly from the reference's names and shapes for the
same configuration, so a width that the port builds otherwise fails
there; a setting that no shape shows is checked by the builder."""

from __future__ import annotations

from types import ModuleType

from ..reference.branches import named


def get(model: str) -> ModuleType:
    """``builders/<model>.py``."""
    return named(__name__, model, "program builder")
