from .base import ModelConfig, ShapeConfig, get_config, list_archs, SHAPES  # noqa: F401
