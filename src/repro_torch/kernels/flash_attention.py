"""Forward flash attention: the Hopper kernel and its PyTorch operator.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_bhsd``). The kernel is hand-written CUDA C++
(``csrc/flash_attention.cu``; its header comment gives the design and
the bound), built by :mod:`.build` and called through ctypes.

It is registered as the custom operator ``repro_torch::flash_attention``:

* on CUDA tensors it launches the kernel (and counts the launch in
  :data:`launches`); there is no fallback — a shape, dtype or layout the
  kernel does not take raises;
* on CPU tensors it runs the plain version, :func:`ref.attention_ref`;
* its fake implementation only allocates the output, so the memory
  tracer sees one op with one output block and no S x S scores — as on
  the card.

The output is allocated as ``[B, Sq, H, d]`` and returned as its
``[B, H, Sq, d]`` view, so the model-layout wrapper gets a contiguous
``[B, S, H, d]`` tensor back without a copy.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (CUDA path only)
launches = 0

_fwd = None


def _entry():
    global _fwd
    if _fwd is None:
        from . import build
        fn = build.load("flash_attention").repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, H, S, d] tensors")
    B, H, Sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k.shape[1]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _empty_out(q):
    B, H, Sq, d = q.shape
    return q.new_empty((B, Sq, H, d)).transpose(1, 2)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int]) -> torch.Tensor:
    global launches
    _check(q, k, v, window)
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, not {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a unit stride on d")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid")
    out = _empty_out(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, Hkv, Sq, Sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


@flash_attention_op.register_kernel("cpu")
def _flash_attention_cpu(q, k, v, causal, window):
    _check(q, k, v, window)
    out = _empty_out(q)
    out.copy_(attention_ref(q, k, v, causal=causal, window=window))
    return out


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window):
    _check(q, k, v, window)
    return _empty_out(q)


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: int | None = None):
    """q: [B, H, Sq, d]; k/v: [B, Hkv, Sk, d] -> [B, H, Sq, d].

    Any strides with a unit stride on d; no padding is needed."""
    return flash_attention_op(q, k, v, causal, window)
