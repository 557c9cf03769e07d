"""Error hierarchy for the data pipeline's filter-and-skip control flow: a
:class:`DataError` rejects one structure and preprocessing goes on."""
from __future__ import annotations


class FrameDiPTError(Exception):
    """Base class of the package's errors."""


class DataError(FrameDiPTError):
    """A data-quality problem; preprocessing skips the structure."""


class MmcifParsingError(DataError):
    pass


class ResolutionError(DataError):
    pass


class LengthError(DataError):
    pass


class ChainError(DataError):
    pass


class SecondaryStructureError(DataError):
    pass
