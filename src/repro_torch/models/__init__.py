"""Model zoo of the port: the dense decoder family."""
from . import convert, layers, model
from .model import (abstract_params, backbone, decode_step, init_cache,
                    init_params, logits_fn)

__all__ = ["convert", "layers", "model", "abstract_params", "backbone",
           "decode_step", "init_cache", "init_params", "logits_fn"]
