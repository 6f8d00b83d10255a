from .node import CfgNode
from .defaults import cfg, get_default_cfg

__all__ = ["CfgNode", "cfg", "get_default_cfg"]
