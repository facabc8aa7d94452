"""Error types (counterpart of reference src/errors.rs)."""


class MapadError(Exception):
    """Base error for mapad_tpu."""


class ParseError(MapadError):
    pass


class InvalidInputType(MapadError):
    pass


class InvalidIndex(MapadError):
    pass


class IndexVersionMismatch(MapadError):
    def __init__(self, found, expected):
        super().__init__(
            f"The version of the index files on disk ({found}) is not compatible with "
            f"this version of mapad_tpu (index version {expected}). Please re-create them."
        )
        self.found = found
        self.expected = expected


class ContigBoundaryOverlap(MapadError):
    pass


class SeqLenError(MapadError):
    def __init__(self, name):
        super().__init__(f'Read "{name}" is too long (max. length 32767 bp)')
