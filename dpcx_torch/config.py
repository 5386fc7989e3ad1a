"""Config reuse: the port reads the same ``Config`` and experiment YAMLs.

``dpcx/config.py`` imports only ``yaml`` at module level (jax is imported
lazily, under ``shard_points`` in ``validate``), and ``dpcx/__init__.py``
imports nothing, so importing it keeps this package free of jax (the port's
entry points refuse ``shard_points`` before calling ``validate``). PyYAML
is installed on the GPU machine as well, so no YAML shim is needed.
"""

from dpcx.config import Config, load_config, save_config

__all__ = ["Config", "load_config", "save_config"]
