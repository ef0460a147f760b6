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
