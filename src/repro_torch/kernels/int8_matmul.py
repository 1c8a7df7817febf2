"""K3: the dequant-fused int8 matmul, and K4: the tiled float matmul.

Ports of the Pallas TPU kernels ``repro/kernels/int8_matmul.py``
(``int8_matmul``) and ``repro/kernels/cache_matmul.py`` (``cache_matmul``),
which share one grid: a (bm, bn) output tile whose fp32 accumulator lives
across the K sweep. On a CUDA tensor ``int8_matmul`` and ``cache_matmul``
launch the hand-written Hopper kernels in ``csrc/int8_matmul.cu`` (one
source, two entry points, one template: K4 is K3 with a bf16 weight, no
conversion and no scale); on a CPU tensor they run their plain versions.
There is no fallback between the two: a CUDA tensor launches the kernel or
raises.

``int8_matmul``: x (M, K) fp32/bf16 @ qw (K, N) int8 with (N,) fp32
per-output-channel scales applied once to the fp32 total -> (M, N) in x's
type, ``round(scale[n] * sum_k x[m, k] * qw[k, n])``. int8 values are
exact in bf16 and fp32, and per-column scales commute with the
contraction, so this equals dequantize-then-matmul up to the order of the
sum, without a float copy of the weights. ``cache_matmul``: x (M, K) @ w
(K, N) of x's type, fp32 accumulation -> (M, N) in x's type.

What bounds each path on the card, and what its design does about it:

- ``wgmma`` (large M: an encoder batch or a prefill, M = B x bucket) is
  bound by operations. ``wgmma`` tensor-core products fed by a ring of
  ``cp.async`` stages (three for 128-row tiles, four for 64 x 64); K3's
  int8 tile goes through registers and is converted to bf16 once per
  stage and block.
- ``split`` (M <= 64: a decode step's M is the batch width) is bound by
  the weight stream. The grid is (column tiles of 32) x (K splits), each
  block's warps streaming its slab of the weight through ``cp.async``
  rings; the splits of a column tile form a thread block cluster whose
  blocks add their fp32 partials in split order through distributed
  shared memory, so the result is deterministic.
- ``masked`` (fp32 x, or rows 16-byte loads cannot read): one block per
  output tile with element-wise loads, the design of the first port.

``matmul_plan`` picks the path, tile and split count from (M, N, K)
alone. The split count comes from (N, K) only, never from M: a row's bits
are then the same at every width M <= 64, which adaptive batch width
needs. The CUDA source's header has the details.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import H100_SMS

# The tiles (bm, bn, bk) the CUDA source is built for, by path. wgmma:
# 128 x 128 and 128 x 192 on two warpgroups, 64 x 64 on one; split: 32
# columns, stages of 128 weight rows, x padded to at most 64 rows; masked:
# 128 x 128 x 32 (8 warps) and 32 x 32 x 128 (4 warps).
TILES = {
    "wgmma": ((128, 128, 64), (128, 192, 64), (64, 64, 64)),
    "split": ((64, 32, 128),),
    "masked": ((128, 128, 32), (32, 32, 128)),
}
SPLIT_MAX_M = 64              # rows the split path takes (x padded to 64)
MAX_SPLITS = 16               # the splits of a column tile form a cluster
SPLIT_ROWS = (16, 32, 64)     # the split kernel's padded row counts
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use
_PATH_CODE = {"masked": 0, "wgmma": 1, "split": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """How K3/K4 run one (M, K) x (K, N) product: the path, its tile
    (bm, bn, bk), and the K splits of ``kslab`` rows each (one split of
    K rows off the split path)."""
    path: str
    tile: tuple
    splits: int
    kslab: int


def matmul_plan(M: int, N: int, K: int) -> Plan:
    """The plan for bf16 x with rows 16-byte loads can read (the wrapper
    takes the masked path otherwise, at the tile of the plan's shape).

    M <= ``SPLIT_MAX_M``: the split path. Its column tiles and its K
    splits come from (N, K) alone: enough splits (at most 16, a cluster)
    that the grid has 2 x 132 blocks, but each split at least two
    128-row stages, since a split of one stage spends about as long on
    the cluster's reduction as on its weight. Larger M: the wgmma path.
    Where a 128 x 128 grid fills the 132 SMs, the tile of 128 rows that
    leaves the busiest SM the least tile area, ceil(blocks / 132) x bm x
    bn (128 x 192 evens out a grid such as 192 tiles of 128 x 128, which
    leaves 60 SMs with two and 72 with one; ties go to 128 x 128); else
    64 x 64."""
    if M <= SPLIT_MAX_M:
        tile = TILES["split"][0]
        bn, bk = tile[1], tile[2]
        steps = -(-K // bk)
        want = min(-(-2 * H100_SMS // -(-N // bn)), MAX_SPLITS)
        kslab = min(steps, max(2, -(-steps // want))) * bk
        return Plan("split", tile, -(-K // kslab), kslab)
    def busiest(tile):
        blocks = -(-M // tile[0]) * -(-N // tile[1])
        return -(-blocks // H100_SMS) * tile[0] * tile[1]
    big, small = TILES["wgmma"][:2], TILES["wgmma"][2]
    if -(-M // big[0][0]) * -(-N // big[0][1]) < H100_SMS:
        return Plan("wgmma", small, 1, K)
    return Plan("wgmma", min(big, key=busiest), 1, K)


def plan_blocks(M: int, N: int, plan: Plan) -> int:
    """Thread blocks of the plan's grid."""
    bm, bn, _ = plan.tile
    if plan.path == "split":
        return -(-N // bn) * plan.splits
    return -(-M // bm) * -(-N // bn)


def smem_bytes(path: str, tile, w_dtype=torch.int8,
               dtype=torch.bfloat16) -> int:
    """Shared memory of one block of the kernel built for (path, tile)
    with bf16 x (or fp32 x on the masked path) and an int8 or bf16 weight,
    as the CUDA source lays it out (``int8_matmul_smem`` there). For the
    split path ``tile[0]`` is the padded row count, 64 at most."""
    bm, bn, bk = tile
    if path == "masked":          # static: x and weight tiles in x's type
        isz = torch.empty((), dtype=dtype).element_size()
        pad = 16 // isz
        return (bm * (bk + pad) + bk * (bn + pad)) * isz
    i8 = w_dtype == torch.int8
    if path == "wgmma":           # the ring, K3's two bf16 B tiles, slack
        stages = 3 if bm == 128 else 4
        stage = bm * bk * 2 + (0 if i8 else bk * bn * 2)
        return 1024 + stages * stage + (2 * bk * bn * 2 if i8 else 0)
    if path == "split":           # four warps' rings of three stages
        rw = bk // 4              # rows a warp streams per stage
        stage = bm * (rw + 8) * 2 + rw * (bn + 16 if i8 else (bn + 8) * 2)
        return max(4 * 3 * stage, 5 * bm * bn * 4)   # or the partials
    raise ValueError(f"unknown path {path!r}")


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


def _check_cuda(x, w, plan: Plan):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    for name, t in (("x", x), ("w", w)):
        if t.stride(1) != 1:
            raise ValueError(f"{name} needs a unit inner stride, got "
                             f"{t.stride()}")
    path, tile = plan.path, tuple(plan.tile)
    if tile not in TILES.get(path, ()):
        raise ValueError(f"tile {tile} is not built for the {path!r} path "
                         f"({TILES})")
    M, K = x.shape
    if path == "split" and (M > SPLIT_MAX_M or plan.kslab % tile[2]
                            or plan.splits > MAX_SPLITS
                            or plan.splits != -(-K // max(plan.kslab, 1))):
        raise ValueError(f"split plan {plan} does not cover M={M}, K={K}")


def _aligned(t, n):
    """16-byte loads of t's rows are aligned and whole (n columns)."""
    per = 16 // t.element_size()
    return int(n % per == 0 and t.stride(0) % per == 0
               and t.data_ptr() % 16 == 0)


def _taken(plan: Plan, x, vec_x, vec_w) -> Plan:
    if x.dtype == torch.bfloat16 and vec_x and vec_w:
        return plan
    tile = TILES["masked"][0 if plan.path == "wgmma" else 1]
    return Plan("masked", tile, 1, x.shape[1])


def launch_plan(x, w, plan: Plan) -> Plan:
    """The plan a launch takes: the given one for bf16 x with rows that
    16-byte loads can read, else the masked path at the tile of the
    plan's shape (128 x 128 x 32 where it says wgmma, 32 x 32 x 128
    where it says split), K unsplit."""
    return _taken(plan, x, _aligned(x, x.shape[1]), _aligned(w, w.shape[1]))


def _lib():
    lib = build.load("int8_matmul")
    if lib.int8_matmul_fwd.argtypes is None:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.int8_matmul_fwd.restype = i
        lib.int8_matmul_fwd.argtypes = [p, p, p, p, i, i, i, i, ll, ll, i,
                                        i, i, i, i, i, i, i, p]
        lib.cache_matmul_fwd.restype = i
        lib.cache_matmul_fwd.argtypes = [p, p, p, i, i, i, i, ll, ll, i, i,
                                         i, i, i, i, i, i, p]
        lib.int8_matmul_smem.restype = i
        lib.int8_matmul_smem.argtypes = [i, i, i, i, i, i]
    return lib


def _launch(fn, x, w, extra, plan: Plan):
    M, K = x.shape
    N = w.shape[1]
    vec_x, vec_w = _aligned(x, K), _aligned(w, N)
    lp = _taken(plan, x, vec_x, vec_w)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), *extra, out.data_ptr(),
                _DTYPE_CODE[x.dtype], M, N, K, x.stride(0), w.stride(0),
                _PATH_CODE[lp.path], *lp.tile, lp.splits, lp.kslab,
                vec_x, vec_w, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    return out


def int8_matmul(x, qw, scale, *, plan: Plan = None):
    """x (M, K) fp32/bf16 @ qw (K, N) int8, scale (N,) fp32 -> (M, N) in
    x's type, the scale applied once to the fp32 total. ``plan`` (default
    ``matmul_plan(M, N, K)``) picks the kernel.

    A CPU tensor runs ``int8_matmul_plain``. A CUDA tensor launches K3
    and adds one to ``int8_matmul.launches``."""
    _check(x, qw, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qw, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda, not {x.device}")
    plan = plan or matmul_plan(x.shape[0], qw.shape[1], x.shape[1])
    _check_cuda(x, qw, plan)
    if qw.dtype != torch.int8:
        raise TypeError(f"qw must be int8, got {qw.dtype}")
    if scale.dtype != torch.float32 or not scale.is_contiguous() \
            or scale.device != x.device:
        raise ValueError("scale must be a contiguous float32 tensor on x's "
                         "device")
    out = _launch(_lib().int8_matmul_fwd, x, qw, (scale.data_ptr(),), plan)
    int8_matmul.launches += 1
    return out


def cache_matmul(x, w, *, plan: Plan = None):
    """x (M, K) @ w (K, N), both fp32 or both bf16 -> (M, N) in x's type,
    fp32 accumulation, at ``plan`` (default ``matmul_plan(M, N, K)``). A
    CPU tensor runs ``cache_matmul_plain``. A CUDA tensor launches K4 and
    adds one to ``cache_matmul.launches``."""
    _check(x, w)
    if x.device.type == "cpu":
        return cache_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"cache_matmul runs on cpu or cuda, not {x.device}")
    plan = plan or matmul_plan(x.shape[0], w.shape[1], x.shape[1])
    _check_cuda(x, w, plan)
    if w.dtype != x.dtype:
        raise TypeError(f"w must be of x's type {x.dtype}, got {w.dtype}")
    out = _launch(_lib().cache_matmul_fwd, x, w, (), plan)
    cache_matmul.launches += 1
    return out


int8_matmul.launches = 0
cache_matmul.launches = 0
