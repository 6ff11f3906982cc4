from . import images  # noqa: F401
