"""Forward flash attention: the Hopper kernels and their PyTorch operator.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_bhsd``) with two hand-written CUDA C++ kernels, built
by :mod:`.build` and called through ctypes (each source's header comment
gives its design and its bound):

* ``"sm90"`` — ``csrc/flash_attention_sm90.cu``: bf16 on the tensor cores
  (``wgmma``, TMA loads on an mbarrier ring, warp specialisation), head
  dims 64, 128 and 256;
* ``"simt"`` — ``csrc/flash_attention.cu``: f32 FMAs on the CUDA cores,
  for f32 at every head dim it takes (f32 on the tensor cores would be
  TF32, too coarse for f32's tolerance) and for bf16 at d 16 and 32.

:func:`route` picks one from the dtype and the head dim alone. It is not
a fallback: a kernel that fails to build or launch raises. A head dim
no kernel takes (kimi-k2's 112) reaches one zero-padded to
:func:`padded_head_dim` by the model-layout wrapper (``ops.py``), with
the scale of the true head dim passed as ``scale``.

The operator is registered as ``repro_torch::flash_attention``:

* on CUDA tensors it launches the routed kernel (and counts the launch in
  :data:`launches` and :data:`launches_by_kernel`); a shape, dtype or
  layout the kernel does not take raises;
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

SM90_HEAD_DIMS = (64, 128, 256)
SIMT_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# kernel -> (source under csrc/, C entry point)
_SOURCES = {"sm90": ("flash_attention_sm90", "repro_flash_attention_sm90_fwd"),
            "simt": ("flash_attention", "repro_flash_attention_fwd")}

#: kernel launches since the last reset (CUDA path only), in all and by
#: kernel
launches = 0
launches_by_kernel = {"sm90": 0, "simt": 0}

_fns: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0
    for key in launches_by_kernel:
        launches_by_kernel[key] = 0


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes ``dtype`` at head dim ``d``: ``"sm90"`` for
    bf16 at d 64, 128, 256; ``"simt"`` for f32 at d 16 to 256 and bf16 at
    d 16, 32. Anything else raises ``ValueError``."""
    if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS:
        return "sm90"
    if dtype in _DTYPE_CODE and d in SIMT_HEAD_DIMS:
        return "simt"
    raise ValueError(f"no flash_attention kernel takes {dtype} at head dim "
                     f"{d} (bf16: {SM90_HEAD_DIMS + SIMT_HEAD_DIMS[:2]}; "
                     f"f32: {SIMT_HEAD_DIMS})")


def padded_head_dim(dtype: torch.dtype, d: int) -> int:
    """The least head dim ``>= d`` that :func:`route` takes for
    ``dtype``: ``d`` itself when a kernel takes it. Raises
    ``ValueError`` when even the largest is too small."""
    dims = SM90_HEAD_DIMS + SIMT_HEAD_DIMS[:2] if dtype == torch.bfloat16 \
        else SIMT_HEAD_DIMS if dtype in _DTYPE_CODE else ()
    for dp in sorted(dims):
        if dp >= d:
            return dp
    return route(dtype, d)       # raises, naming what the kernels take


def _entry(kernel: str):
    fn = _fns.get(kernel)
    if fn is None:
        from . import build
        source, symbol = _SOURCES[kernel]
        fn = getattr(build.load(source), symbol)
        n_ints = 7 if kernel == "simt" else 6    # simt also takes a dtype
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[kernel] = fn
    return fn


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


def check_tma(*tensors) -> None:
    """Raise ``ValueError`` unless TMA can read each tensor in place: a
    16-byte aligned base, a unit stride on d and 16-byte strides on the
    other dims (a dim of size 1 has no stride that matters)."""
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError("flash_attention kernel needs a unit stride "
                             "on d")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention sm90 kernel needs a 16-byte "
                             "aligned base address")
        for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
            if size > 1 and (stride * t.element_size()) % 16:
                raise ValueError(f"flash_attention sm90 kernel needs "
                                 f"16-byte strides, got {t.stride()} "
                                 f"elements")


def _empty_out(q):
    B, H, Sq, d = q.shape
    return q.new_empty((B, Sq, H, d)).transpose(1, 2)


def launch(kernel: str, q, k, v, *, causal: bool = True,
           window: int | None = None,
           scale: float | None = None) -> torch.Tensor:
    """Launch ``kernel`` ("sm90" or "simt") on CUDA tensors q [B, H, Sq,
    d], k/v [B, Hkv, Sk, d] and count the launch; the scores are scaled
    by ``scale`` (default ``1/sqrt(d)``). The operator calls it with
    :func:`route`'s choice; a caller that holds one kernel against the
    plain version may name it. Raises on what the kernel does not
    take."""
    global launches
    _check(q, k, v, window)
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if kernel == "sm90":
        if q.dtype != torch.bfloat16 or d not in SM90_HEAD_DIMS:
            raise ValueError(f"the sm90 kernel takes bf16 at head dims "
                             f"{SM90_HEAD_DIMS}, not {q.dtype} at {d}")
        check_tma(q, k, v)
    else:
        if q.dtype not in _DTYPE_CODE or d not in SIMT_HEAD_DIMS:
            raise ValueError(f"the simt kernel takes f32 or bf16 at head "
                             f"dims {SIMT_HEAD_DIMS}, not {q.dtype} at {d}")
        if any(t.stride(3) != 1 for t in (q, k, v)):
            raise ValueError("flash_attention kernel needs a unit stride "
                             "on d")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("q, k and v must be on one CUDA device")
    if (B * H > 65535 if kernel == "simt"
            else B * H * -(-Sq // 128) >= 2**31):
        raise ValueError(f"B*H = {B * H}, Sq = {Sq} exceed the {kernel} "
                         f"kernel's grid")
    out = _empty_out(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    dtype = [] if kernel == "sm90" else [_DTYPE_CODE[q.dtype]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry(kernel)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *dtype, B, H, Hkv, Sq, Sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(d) if scale is None else float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           f"error {err} (a cudaError_t; 1000 + n: tensor "
                           f"map encoding returned CUresult n)")
    launches += 1
    launches_by_kernel[kernel] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int],
                       scale: Optional[float] = None) -> torch.Tensor:
    _check(q, k, v, window)
    return launch(route(q.dtype, q.shape[3]), q, k, v, causal=causal,
                  window=window, scale=scale)


@flash_attention_op.register_kernel("cpu")
def _flash_attention_cpu(q, k, v, causal, window, scale=None):
    _check(q, k, v, window)
    out = _empty_out(q)
    out.copy_(attention_ref(q, k, v, causal=causal, window=window,
                            scale=scale))
    return out


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, scale=None):
    _check(q, k, v, window)
    return _empty_out(q)


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         scale: float | None = None):
    """q: [B, H, Sq, d]; k/v: [B, Hkv, Sk, d] -> [B, H, Sq, d]; scores
    scaled by ``scale`` (default ``1/sqrt(d)``).

    Any strides with a unit stride on d; no padding is needed."""
    return flash_attention_op(q, k, v, causal, window, scale)
