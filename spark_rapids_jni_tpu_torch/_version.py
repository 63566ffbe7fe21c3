"""Single source of the port's base version string.

Imported by the package ``__init__`` as ``__version__``, and read by
``exec/artifacts.py``, whose store key carries it: a persisted capture
tape is only valid for the package version that recorded it.
"""

BASE_VERSION = "0.2.0.dev0"
