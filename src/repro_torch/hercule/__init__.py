"""Hercule-style parallel I/O and data management (paper §2).

Shared machinery in :mod:`database`: *contexts* (one per time step),
*domains* (one per contributor), contributor groups of NCF processes
sharing one physical file, and max-file-size rollover. The unified
object layer lives in :mod:`api`: typed ObjectKinds, a codec registry,
indexed :class:`~repro_torch.hercule.api.ContextView` handles and the
shared :class:`~repro_torch.hercule.api.Selector` query object. Files
are byte-identical to the ones ``repro.hercule`` writes.
"""
from . import api  # noqa: F401  (registers object kinds + fpdelta codecs)
from .api import (ContextView, Selector, read_object, scan,  # noqa: F401
                  write_object)
from .database import (ContextWriter, HerculeDB, Record,  # noqa: F401
                       codec_names, decode_record, register_codec)
