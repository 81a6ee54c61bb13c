from .scalar_diffusivity import HORIZONTAL, ISO, VERTICAL, ScalarDiffusivity

__all__ = ["ScalarDiffusivity", "ISO", "HORIZONTAL", "VERTICAL"]
