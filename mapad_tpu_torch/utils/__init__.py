from . import f32, seq  # noqa: F401
