"""The port's exceptions.

Counterpart of ``strawboat_tpu/errors.py`` (the reference's src/errors.rs:
arrow2's ``OutOfSpec`` / ``NotYetImplemented`` variants), with the classes
the port raises.
"""


class StrawboatError(Exception):
    """Base error of the port."""


class OutOfSpecError(StrawboatError):
    """The file or bytes violate the format spec."""


class NotYetImplementedError(StrawboatError):
    """A feature of the JAX package the port does not have yet."""


class CapacityError(StrawboatError):
    """A capacity (group slots, join fan-out) overflowed.

    Raised instead of silently dropping or collapsing rows; carries the
    capacity actually required so callers can retry with a larger size."""

    def __init__(self, what: str, capacity: int, required: int):
        super().__init__(f"{what} overflow: capacity {capacity} < required {required}")
        self.what = what
        self.capacity = capacity
        self.required = required
