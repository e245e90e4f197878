"""Adaptive control plane (counterpart of ``swiftmpi_tpu/control/``):
online re-derivation of the placement and wire knobs from the live
traffic ledger.

See :mod:`swiftmpi_tpu_torch.control.controller` for the decision loop
and :mod:`swiftmpi_tpu_torch.control.sketch` for the decayed frequency
sketch.  The wiring lives with the owner: ``models/word2vec.py``
registers the ``hot_k``, ``push_window``, ``wire_format`` and
``collective`` knobs and their appliers.
"""

from swiftmpi_tpu_torch.control.controller import (Controller,
                                                   ControlSettings, Decision,
                                                   Knob, Proposal)
from swiftmpi_tpu_torch.control.sketch import DecayedSketch

__all__ = ["Controller", "ControlSettings", "Decision", "Knob",
           "Proposal", "DecayedSketch"]
