from . import ir, compile as compiler  # noqa: F401
