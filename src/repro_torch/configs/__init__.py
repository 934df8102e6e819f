"""Architecture configs of the port (plain dataclasses, no framework)."""
from repro_torch.configs.base import (ARCH_IDS, PORTED, SHAPES, ArchConfig,
                                      InputShape, get_config, reduced)

__all__ = ["ARCH_IDS", "PORTED", "SHAPES", "ArchConfig", "InputShape",
           "get_config", "reduced"]
