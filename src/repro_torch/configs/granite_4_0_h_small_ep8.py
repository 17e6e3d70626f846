"""granite-4.0-h-small's one-device share, ``granite_4_0_h_small.SHARE``,
under the name of the model in portbench's configuration of the cell:
``get_config`` finds a model's preset by its name. The cut is defined
there; this module only names it."""
from .granite_4_0_h_small import SHARE as CONFIG  # noqa: F401
