"""Model zoo of the port: every family of the JAX package's."""
from . import convert, layers, mamba, model, moe, xlstm
from .model import (abstract_params, backbone, decode_step, init_cache,
                    init_params, logits_fn, loss_fn)

__all__ = ["convert", "layers", "mamba", "model", "moe", "xlstm",
           "abstract_params", "backbone", "decode_step", "init_cache",
           "init_params", "logits_fn", "loss_fn"]
