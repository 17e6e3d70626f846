"""Counting a traced training step's synchronizing CUDA calls.

torch's sync debug mode (``torch.cuda.set_sync_debug_mode("warn")``)
warns at each CUDA call that makes the host wait for the card.
:class:`SyncCounter` installs, once for a run, a warnings filter that
lets every one of those warnings through (Python shows a warning once
per call site by default) and a ``showwarning`` hook that counts them
and prints none; a step then only turns the mode and the count on and
off around itself (:meth:`SyncCounter.counting`).

A step's syncs come from its own thread and from the autograd engine's
device thread: the engine replays its C++ ops' warnings on the caller
at the end of the backward, and Python it runs there (a custom
backward, remat's recompute) warns on the engine's thread, inside the
graph task. Other threads' syncs during the step (the in-transit
lanes') are dropped unprinted.
"""
from __future__ import annotations

import contextlib
import threading
import warnings

import torch

from ..models.probe import in_backward

#: the message of torch's sync debug mode
SYNC_WARNING = "called a synchronizing CUDA operation"


class SyncCounter:
    """Counts the synchronizing CUDA calls of the steps it is asked to
    count (see the module)."""

    def __init__(self):
        self.count = 0
        self._thread = None         # the counting thread, while counting
        self._saved = None          # the warnings state to put back

    def _install(self) -> None:
        """Install the filter and the hook (once; until
        :meth:`uninstall`)."""
        if self._saved is not None:
            return
        self._saved = warnings.catch_warnings()
        self._saved.__enter__()
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if self._thread is None or SYNC_WARNING not in str(message):
                shown(message, category, filename, lineno, file, line)
            elif threading.get_ident() == self._thread or in_backward():
                self.count += 1
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        warnings.showwarning = show

    def uninstall(self) -> None:
        """Put the warnings filters and ``showwarning`` back."""
        if self._saved is not None:
            self._saved.__exit__(None, None, None)
            self._saved = None

    @contextlib.contextmanager
    def counting(self):
        """Counts the block's syncs into :attr:`count` (from 0), with the
        sync debug mode at ``"warn"`` and put back after it."""
        self._install()
        mode = torch.cuda.get_sync_debug_mode()
        self.count = 0
        self._thread = threading.get_ident()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield self
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            self._thread = None
