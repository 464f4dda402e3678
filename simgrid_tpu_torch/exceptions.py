"""User-visible simulation exceptions.

The port's copy of ``simgrid_tpu/exceptions.py``.

Equivalents of the reference's simgrid::Exception hierarchy
(include/simgrid/Exception.hpp): raised inside actor code
when the simulated world misbehaves (timeouts, failed resources, canceled
activities).
"""


class SimgridException(Exception):
    """Base of every simulation-level exception; `value` carries the index
    of the failed activity for waitany/testany."""

    def __init__(self, message: str = "", value: int = 0):
        super().__init__(message)
        self.value = value


class TimeoutException(SimgridException):
    pass


class HostFailureException(SimgridException):
    pass


class NetworkFailureException(SimgridException):
    pass


class StorageFailureException(SimgridException):
    pass


class VmFailureException(SimgridException):
    pass


class CancelException(SimgridException):
    pass


class TracingError(SimgridException):
    pass


class ParseError(SimgridException):
    """Platform file parsing error."""


class ForcefulKillException(BaseException):
    """Internal: unwinds an actor's stack when it gets killed.  Derives from
    BaseException so user `except Exception` blocks don't swallow it (the
    reference relies on C++ stack unwinding the same way,
    ActorImpl.cpp:230)."""
