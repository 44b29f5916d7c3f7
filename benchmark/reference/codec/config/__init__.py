from .standards import VidConfig, REGISTRY, get_mode, list_modes  # noqa: F401
