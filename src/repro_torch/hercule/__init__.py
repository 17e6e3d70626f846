"""Hercule-style parallel I/O and data management (paper §2).

Two database kinds, written at independent frequencies (fig. 1):

  * HProt — checkpoint/restart: raw, coarse-grained, code-private
    (:mod:`checkpoint`, and the async manager in ``repro_torch.ckpt``).
  * HDep — post-processing: self-describing, pruned, compressed
    (:mod:`hdep`, the object kinds of :mod:`api`).

Shared machinery in :mod:`database`: *contexts* (one per time step /
checkpoint step), *domains* (one per contributor), contributor groups of
NCF processes sharing one physical file, and max-file-size rollover.

The unified object layer lives in :mod:`api`: typed ObjectKinds
(``amr_tree`` / ``analysis`` / ``reduced`` / ``ckpt_shard``), a codec
registry, indexed :class:`~repro_torch.hercule.api.ContextView` handles
and the shared :class:`~repro_torch.hercule.api.Selector` query object
(DESIGN.md §11). Files are byte-identical to the ones ``repro.hercule``
writes, and each package reads the other's.
"""
from . import api  # noqa: F401  (registers object kinds + fpdelta codecs)
from .api import (ContextView, Selector, read_object, scan,  # noqa: F401
                  write_object)
from .database import (ContextWriter, HerculeDB, Record,  # noqa: F401
                       codec_names, decode_record, register_codec)
