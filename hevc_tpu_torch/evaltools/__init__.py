from . import hm  # noqa: F401
