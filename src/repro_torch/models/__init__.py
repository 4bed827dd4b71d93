"""Model zoo of the port: the dense and MoE decoder families."""
from . import convert, layers, model, moe
from .model import (abstract_params, backbone, decode_step, init_cache,
                    init_params, logits_fn, loss_fn)

__all__ = ["convert", "layers", "model", "moe", "abstract_params", "backbone",
           "decode_step", "init_cache", "init_params", "logits_fn", "loss_fn"]
