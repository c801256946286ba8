from .loader import Config, apply_options, dump_config, load_config, parse_options

__all__ = ["Config", "apply_options", "dump_config", "load_config", "parse_options"]
