from .fmd import BiInterval, FmdIndex  # noqa: F401
from .runtime import (  # noqa: F401
    FastaIdPosition,
    FastaIdPositions,
    Index,
    OriginalSymbols,
    SampledSuffixArray,
    load_index,
)
from .builder import build_auxiliary_structures, run as build_index  # noqa: F401
