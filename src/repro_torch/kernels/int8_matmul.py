"""K3: the dequant-fused int8 matmul, and K4: the tiled float matmul.

Ports of the Pallas TPU kernels ``repro/kernels/int8_matmul.py``
(``int8_matmul``) and ``repro/kernels/cache_matmul.py`` (``cache_matmul``),
which share one grid: a (bm, bn) output tile whose fp32 accumulator lives
across the K sweep. On a CUDA tensor ``int8_matmul`` and ``cache_matmul``
launch the hand-written Hopper kernels in ``csrc/int8_matmul.cu`` (one
source, two entry points); on a CPU tensor they run their plain versions.
There is no fallback between the two: a CUDA tensor launches the kernel or
raises.

``int8_matmul``: x (M, K) fp32/bf16 @ qw (K, N) int8 with (N,) fp32
per-output-channel scales applied once at the fp32 accumulator -> (M, N)
in x's type, ``round(scale[n] * sum_k x[m, k] * qw[k, n])``. int8 values
are exact in bf16 and fp32, and per-column scales commute with the
contraction, so this equals dequantize-then-matmul up to the order of the
sum, without a float copy of the weights. ``cache_matmul``: x (M, K) @ w
(K, N) of x's type, fp32 accumulation -> (M, N) in x's type.

Both read x and the weight through their row strides (the inner stride
must be 1) and mask ragged M, N and K themselves; the TPU wrappers pad to
whole 128 tiles. What bounds the kernels on the card, and what their
design does about it, is set out at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# The tiles the CUDA source is built for, (bm, bn, bk): 8 warps on a
# 128 x 128 tile for products that fill the card, 4 warps on 32 x 32 with
# a deeper K step for small M (csrc: Large, Small).
TILE_LARGE = (128, 128, 32)
TILE_SMALL = (32, 32, 128)
TILES = (TILE_LARGE, TILE_SMALL)
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(bm: int, bn: int, bk: int, dtype=torch.bfloat16) -> int:
    """Shared memory of one block: the (bm, bk) x tile and the (bk, bn)
    weight tile, both staged in x's type with rows padded by 16 bytes
    (the port of the TPU kernels' ``vmem_bytes``; the accumulator lives
    in registers here)."""
    isz = torch.empty((), dtype=dtype).element_size()
    pad = 16 // isz
    return (bm * (bk + pad) + bk * (bn + pad)) * isz


def int8_matmul_plain(x, qw, scale):
    """Dequantize, then matmul in fp32 (``ref.int8_matmul_ref``), rounded
    to x's type as the kernel's output is: (M, K) float, (K, N) int8,
    (N,) fp32 -> (M, N) x.dtype."""
    w = qw.float() * scale.float()[None, :]
    return (x.float() @ w).to(x.dtype)


def cache_matmul_plain(x, w):
    """Matmul in fp32 (``ref.matmul_ref``), rounded to x's type."""
    return (x.float() @ w.float()).to(x.dtype)


def _check(x, w, scale=None):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must "
                         f"be (M, K) and (K, N)")
    if scale is not None and tuple(scale.shape) != (w.shape[1],):
        raise ValueError(f"scale {tuple(scale.shape)} must be "
                         f"({w.shape[1]},)")
    if min(x.shape[0], x.shape[1], w.shape[1]) < 1:
        raise ValueError(f"empty product: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")


def _check_cuda(x, w, tile):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    for name, t in (("x", x), ("w", w)):
        if t.stride(1) != 1:
            raise ValueError(f"{name} needs a unit inner stride, got "
                             f"{t.stride()}")
    if tile not in TILES:
        raise ValueError(f"tile {tile} is not one of the built tiles "
                         f"{TILES}")
    if smem_bytes(*tile, dtype=x.dtype) > SMEM_LIMIT:
        raise ValueError(f"tile {tile} needs {smem_bytes(*tile, x.dtype)} "
                         f"bytes of shared memory, above {SMEM_LIMIT}")


def _aligned(t, n):
    """16-byte loads of t's rows are aligned and whole (n columns)."""
    per = 16 // t.element_size()
    return int(n % per == 0 and t.stride(0) % per == 0
               and t.data_ptr() % 16 == 0)


def _lib():
    lib = build.load("int8_matmul")
    if lib.int8_matmul_fwd.argtypes is None:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.int8_matmul_fwd.restype = i
        lib.int8_matmul_fwd.argtypes = [p, p, p, p, i, i, i, i, ll, ll,
                                        i, i, i, i, i, p]
        lib.cache_matmul_fwd.restype = i
        lib.cache_matmul_fwd.argtypes = [p, p, p, i, i, i, i, ll, ll,
                                         i, i, i, i, i, p]
    return lib


def _launch(fn, x, w, extra, tile):
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), *extra, out.data_ptr(),
                _DTYPE_CODE[x.dtype], M, N, K, x.stride(0), w.stride(0),
                *tile, _aligned(x, K), _aligned(w, N), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    return out


def int8_matmul(x, qw, scale, *, tile=TILE_LARGE):
    """x (M, K) fp32/bf16 @ qw (K, N) int8, scale (N,) fp32 -> (M, N) in
    x's type, scale applied at the fp32 accumulator. ``tile`` is one of
    ``TILES`` (``ops.matmul_tile`` picks it).

    A CPU tensor runs ``int8_matmul_plain``. A CUDA tensor launches K3 and
    adds one to ``int8_matmul.launches``."""
    _check(x, qw, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qw, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda, not {x.device}")
    _check_cuda(x, qw, tuple(tile))
    if qw.dtype != torch.int8:
        raise TypeError(f"qw must be int8, got {qw.dtype}")
    if scale.dtype != torch.float32 or not scale.is_contiguous() \
            or scale.device != x.device:
        raise ValueError("scale must be a contiguous float32 tensor on x's "
                         "device")
    out = _launch(_lib().int8_matmul_fwd, x, qw, (scale.data_ptr(),),
                  tuple(tile))
    int8_matmul.launches += 1
    return out


def cache_matmul(x, w, *, tile=TILE_LARGE):
    """x (M, K) @ w (K, N), both fp32 or both bf16 -> (M, N) in x's type,
    fp32 accumulation. A CPU tensor runs ``cache_matmul_plain``. A CUDA
    tensor launches K4 and adds one to ``cache_matmul.launches``."""
    _check(x, w)
    if x.device.type == "cpu":
        return cache_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"cache_matmul runs on cpu or cuda, not {x.device}")
    _check_cuda(x, w, tuple(tile))
    if w.dtype != x.dtype:
        raise TypeError(f"w must be of x's type {x.dtype}, got {w.dtype}")
    out = _launch(_lib().cache_matmul_fwd, x, w, (), tuple(tile))
    cache_matmul.launches += 1
    return out


int8_matmul.launches = 0
cache_matmul.launches = 0
