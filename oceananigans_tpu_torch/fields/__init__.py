from .field import Field, set_on_padded

__all__ = ["Field", "set_on_padded"]
